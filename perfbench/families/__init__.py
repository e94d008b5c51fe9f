"""One module per model family of the port: how a configuration file
becomes the port's model config, the parameter tree the benchmark fills
from the seed, and the plain reference that follows the steps."""
