"""The reference's four ``examples/*.py`` through the port, each run with
``python -m repro_torch.examples.<name>`` and a ``--device`` (default: the
GPU)."""
