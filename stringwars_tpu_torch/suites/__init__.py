"""Runnable benchmark suites: ``python -m stringwars_tpu_torch.suites.<name>``."""
