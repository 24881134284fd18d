"""Config registry of the port: the architectures its slice serves.

``base.py`` and the per-model files are copies of ``repro.configs`` (the
port imports nothing from the JAX package)."""
from . import glm4_9b, zamba2_7b
from .base import ArchConfig, LayerSpec

ARCHS: dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG
                                for m in (glm4_9b, zamba2_7b)}


__all__ = ["ArchConfig", "LayerSpec", "ARCHS"]
