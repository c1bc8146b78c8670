"""Fused candidate light alignment + best-pair reduction."""
