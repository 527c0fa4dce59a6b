"""Launchers of the port. Counterpart of ``repro/launch``: ``train``, the
multi-pod DiLoCo driver (``python -m repro_torch.launch.train``)."""
