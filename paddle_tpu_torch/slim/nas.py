# Copied from the JAX package: paddle_tpu/slim/nas.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""Network architecture search: simulated-annealing controller + TCP
controller server / search agent.

Reference: contrib/slim/searcher/controller.py:59 SAController,
contrib/slim/nas/controller_server.py (socket server speaking
"tokens,...\\treward" lines) and nas/search_agent.py (client:
`update(tokens, reward)` → next tokens), light_nas_strategy.py wires them
into training. The same roles here: the server owns the SAController, N
distributed trainers pull candidate token vectors, train/eval them, and
report rewards.
"""

from __future__ import annotations

import math
import random
import socket
import threading
from typing import List, Optional, Sequence


class SAController:
    """Simulated annealing over integer token vectors
    (reference: controller.py:59 — reduce_rate, init_temperature)."""

    def __init__(self, range_table: Sequence[int],
                 reduce_rate: float = 0.85,
                 init_temperature: float = 1024.0,
                 max_iter_number: int = 300,
                 seed: Optional[int] = None):
        self.range_table = list(range_table)
        self.reduce_rate = reduce_rate
        self.init_temperature = init_temperature
        self.max_iter_number = max_iter_number
        self._rng = random.Random(seed)
        self._iter = 0
        self.tokens = [self._rng.randrange(r) for r in self.range_table]
        self.reward = -float("inf")
        self.best_tokens = list(self.tokens)
        self.best_reward = -float("inf")

    def next_tokens(self) -> List[int]:
        """Propose a neighbor of the current accepted tokens."""
        cand = list(self.tokens)
        idx = self._rng.randrange(len(cand))
        cand[idx] = self._rng.randrange(self.range_table[idx])
        return cand

    @property
    def is_finished(self) -> bool:
        return self._iter >= self.max_iter_number

    def update(self, tokens: Sequence[int], reward: float) -> bool:
        """Metropolis accept/reject; returns True if accepted. After
        max_iter_number updates the search is finished and further
        rewards are recorded for `best` only."""
        if self.is_finished:
            if reward > self.best_reward:
                self.best_reward = reward
                self.best_tokens = list(tokens)
            return False
        self._iter += 1
        temperature = self.init_temperature * \
            self.reduce_rate ** self._iter
        if reward > self.best_reward:
            self.best_reward = reward
            self.best_tokens = list(tokens)
        delta = reward - self.reward
        accept = delta > 0 or self._rng.random() < math.exp(
            min(delta / max(temperature, 1e-9), 0.0))
        if accept:
            self.tokens = list(tokens)
            self.reward = reward
        return accept


class ControllerServer:
    """TCP server owning a controller (reference:
    controller_server.py:28). Protocol (line per request):
      'next_tokens'              -> 'tok1,tok2,...'
      'update\\ttok1,...\\treward' -> 'ok <accepted> <best_reward>'
      'best'                     -> 'tok1,...\\tbest_reward'
      'close'                    -> shuts the server down
    """

    def __init__(self, controller: SAController, address=("127.0.0.1", 0),
                 max_client_num: int = 10):
        self._controller = controller
        self._socket = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._socket.bind(address)
        self._socket.listen(max_client_num)
        self._port = self._socket.getsockname()[1]
        self._ip = self._socket.getsockname()[0]
        self._closed = False
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    @property
    def ip(self) -> str:
        return self._ip

    @property
    def port(self) -> int:
        return self._port

    def start(self):
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()

    def run(self):
        while not self._closed:
            try:
                conn, _ = self._socket.accept()
            except OSError:
                break
            # one bad client must never kill the accept loop
            try:
                with conn:
                    chunks = []
                    while True:
                        b = conn.recv(65536)
                        if not b:
                            break
                        chunks.append(b)
                    try:
                        data = b"".join(chunks).decode("utf-8").strip()
                        resp = self._handle(data)
                    except Exception as e:  # malformed/non-UTF-8 request
                        resp = f"error {type(e).__name__}: {e}"
                    conn.sendall(resp.encode("utf-8"))
            except OSError:
                continue

    def _handle(self, data: str) -> str:
        with self._lock:
            if data == "next_tokens":
                return ",".join(map(str, self._controller.next_tokens()))
            if data == "best":
                return ",".join(map(str, self._controller.best_tokens)) + \
                    "\t" + repr(self._controller.best_reward)
            if data.startswith("update\t"):
                _, toks, reward = data.split("\t")
                tokens = [int(t) for t in toks.split(",")]
                accepted = self._controller.update(tokens, float(reward))
                return f"ok {int(accepted)} {self._controller.best_reward!r}"
            if data == "close":
                self.close()
                return "closed"
            return "error unknown request"

    def close(self):
        self._closed = True
        try:
            self._socket.close()
        except OSError:
            pass
        # join the accept loop so close() returning means the port is
        # actually released — EXCEPT when close() is called from the
        # serve thread itself (the "close" request arrives through
        # _handle, which runs ON self._thread; joining would self-wait)
        t = self._thread
        if t is not None and t is not threading.current_thread() \
                and t.is_alive():
            t.join(timeout=5.0)


class SearchAgent:
    """Client side (reference: search_agent.py:25)."""

    def __init__(self, server_ip: str, server_port: int):
        self.server_ip = server_ip
        self.server_port = server_port

    def _request(self, msg: str) -> str:
        with socket.create_connection((self.server_ip, self.server_port),
                                      timeout=30) as s:
            s.sendall(msg.encode("utf-8"))
            s.shutdown(socket.SHUT_WR)
            chunks = []
            while True:
                b = s.recv(65536)
                if not b:
                    break
                chunks.append(b)
        return b"".join(chunks).decode("utf-8")

    def next_tokens(self) -> List[int]:
        return [int(t) for t in self._request("next_tokens").split(",")]

    def update(self, tokens: Sequence[int], reward: float) -> bool:
        resp = self._request(
            "update\t" + ",".join(map(str, tokens)) + f"\t{reward!r}")
        return resp.startswith("ok 1")

    def best(self):
        toks, reward = self._request("best").split("\t")
        return [int(t) for t in toks.split(",")], float(reward)

    def close_server(self):
        self._request("close")
