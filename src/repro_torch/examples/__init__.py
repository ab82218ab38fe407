"""Twins of the reference's ``examples/`` scripts on the port:
``quickstart``, ``train_lm_100m`` and ``serve_decode`` (run each with
``python -m repro_torch.examples.<name>``; the twin of
``train_fmnist_tt.py`` is ``repro_torch.launch.train_fmnist``)."""
