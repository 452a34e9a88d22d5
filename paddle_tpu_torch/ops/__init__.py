"""Operators of the port: attention dispatch and beam search."""
