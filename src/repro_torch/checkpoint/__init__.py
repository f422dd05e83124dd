"""Checkpointing: a msgpack manifest + numpy buffers (port of ``repro/checkpoint``)."""
from repro_torch.checkpoint.msgpack_ckpt import restore_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "restore_checkpoint"]
