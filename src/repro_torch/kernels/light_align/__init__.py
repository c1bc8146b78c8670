"""Standalone Light Alignment of reads against windows (a building block)."""
