"""Registers the ``cuda`` marker: tests that run a CUDA kernel and need
an NVIDIA card. They decide inside a fixture whether a card is present
and skip with a reason where there is none."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (runs the port's CUDA "
        "kernels); skipped where torch.cuda.is_available() is false")
