"""Loaders. Counterpart of ``pytorch_geometric_tpu/loader``; only the scan
pair is ported so far (the samplers and loaders are ROADMAP Queue 1, item
8)."""

from .scan_train import make_device_train_step, stack_batches

__all__ = ['stack_batches', 'make_device_train_step']
