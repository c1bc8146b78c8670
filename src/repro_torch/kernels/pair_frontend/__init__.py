"""Fused pipeline front end: seeding + SeedMap query + Δ filter."""
