"""Command-line launchers and drivers of the port: the stream launcher
(``python -m repro_torch.launch.stream``), the continuous-batching
serving driver (``python -m repro_torch.launch.serve``, ``serve.
ServingEngine``), the training driver (``python -m repro_torch.launch.
train``, ``train.Trainer``), their step functions and the
(architecture x shape x mesh) cells (``cells``), the meshes (``mesh``)
and the dry run (``python -m repro_torch.launch.dryrun``)."""
