"""Batched solves: many same-shape LPs, or many rhs scenarios of one, at once."""
