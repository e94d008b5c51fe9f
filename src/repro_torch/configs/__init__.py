"""Published model configurations."""
