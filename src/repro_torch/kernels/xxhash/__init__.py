"""Standalone xxHash32 of 16-byte messages (a building block)."""
