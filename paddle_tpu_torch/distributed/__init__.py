"""Distributed launchers of the port: the file-store rendezvous
(`rendezvous.FileRendezvous`) that serving replicas register in and the
fleet router reads, and the replica supervisor
(`python -m paddle_tpu_torch.distributed.launch_serve`).

The submodules are imported lazily, so `python -m` does not warn about
a double import. The training world's elastic launcher (the JAX
package's `launch.py` and `elastic.py`) is not ported (ROADMAP item
20e)."""
