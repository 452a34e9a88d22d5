"""Core runtime pieces of the port (precision policies)."""
