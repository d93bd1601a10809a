"""Build and load the port's CUDA kernels (`build.py`)."""
