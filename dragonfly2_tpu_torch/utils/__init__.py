"""Shared kernel utilities (mirrors the reference's pkg/ + internal/ layer)."""
