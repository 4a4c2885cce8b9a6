"""Command-line launchers and drivers of the port: the stream launcher
(``python -m repro_torch.launch.stream``), the continuous-batching
serving driver (``python -m repro_torch.launch.serve``, ``serve.
ServingEngine``), the training driver (``python -m repro_torch.launch.
train``, ``train.Trainer``) and their step functions (``cells``)."""
