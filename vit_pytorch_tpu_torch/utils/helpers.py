"""Small shared helpers (reference vit.py:10-11; JAX package utils/helpers.py)."""

from __future__ import annotations


def exists(v):
    return v is not None


def default(v, d):
    return v if exists(v) else d


def pair(t):
    """reference vit.py:10-11"""
    return t if isinstance(t, (tuple, list)) else (t, t)
