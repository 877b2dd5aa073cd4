"""Utilities: image IO, logging/metrics, profiling, session checkpoints."""

from l2n.utils.image import write_png, tonemap_to_u8  # noqa: F401
