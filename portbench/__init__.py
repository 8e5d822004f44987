"""The benchmark of the PyTorch/CUDA port (``repro_torch``): the serving
control loop under open-loop traffic, in wall time (see ``run.py``)."""
