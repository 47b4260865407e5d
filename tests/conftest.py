def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card (CUDA kernels have no CPU mode); the "
        "test skips itself where torch.cuda.is_available() is False")
