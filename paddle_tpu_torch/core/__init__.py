"""Helpers shared across the port: nested-dict trees (`tree`) and numeric
helpers for the optimizers (`numerics`)."""
