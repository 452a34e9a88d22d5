"""Incubating APIs (reference: python/paddle/fluid/incubate/): the
collective fleet under its canonical import paths."""
