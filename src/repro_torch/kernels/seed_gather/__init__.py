"""NMSL row gather of padded SeedMap rows (a building block)."""
