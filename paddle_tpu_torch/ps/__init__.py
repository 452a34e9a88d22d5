"""The parameter-server tier's typed errors (`errors.py`), which the
training loop routes to its recovery policy. The rest of the tier (the
client, the server, the transpiler) is not ported (ROADMAP item 21)."""
