"""Stateless feature-id hashing into a fixed vocabulary.

An exact copy of ``fast_tffm_tpu/data/hashing.py``'s scalar hash: 64-bit
FNV-1a over the raw token bytes, reduced modulo the vocabulary.  Both
packages must map a raw token to the same row, or a checkpoint trained by
one would score garbage in the other.
"""

from __future__ import annotations

__all__ = ["fnv1a64", "hash_feature_id"]

FNV_OFFSET = 0xCBF29CE484222325
FNV_PRIME = 0x100000001B3
_MASK = 0xFFFFFFFFFFFFFFFF


def fnv1a64(token: bytes) -> int:
    """64-bit FNV-1a of a byte string."""
    h = FNV_OFFSET
    for b in token:
        h = ((h ^ b) * FNV_PRIME) & _MASK
    return h


def hash_feature_id(token: str | bytes, vocabulary_size: int) -> int:
    """Map a raw feature token to a stable id in [0, vocabulary_size)."""
    if isinstance(token, str):
        token = token.encode("utf-8")
    return fnv1a64(token) % vocabulary_size
