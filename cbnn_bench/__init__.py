"""The benchmark of the PyTorch/CUDA port of CBNN: secure classifier
serving on one NVIDIA H100 (``python3 cbnn_bench/run.py --help``)."""
