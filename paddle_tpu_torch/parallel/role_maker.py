# Copied from the JAX package's paddle_tpu/parallel/role_maker.py; nothing else differs.

"""Role makers: who am I in the cluster?

Reference: incubate/fleet/base/role_maker.py — PaddleCloudRoleMaker reads
PADDLE_TRAINER_ID / PADDLE_TRAINER_ENDPOINTS / TRAINING_ROLE env vars set by
paddle.distributed.launch; UserDefinedRoleMaker takes them explicitly.

TPU-native: the same env contract (so launch scripts port unchanged), plus
the JAX coordinator address for jax.distributed.initialize.
"""

from __future__ import annotations

import os
from typing import List, Optional


class Role:
    WORKER = 1
    SERVER = 2


class RoleMakerBase:
    def __init__(self):
        self._worker_index = 0
        self._worker_num = 1
        self._server_endpoints: List[str] = []
        self._worker_endpoints: List[str] = []
        self._role = Role.WORKER

    def is_worker(self) -> bool:
        return self._role == Role.WORKER

    def is_server(self) -> bool:
        return self._role == Role.SERVER

    def is_first_worker(self) -> bool:
        return self.is_worker() and self._worker_index == 0

    def worker_index(self) -> int:
        return self._worker_index

    def worker_num(self) -> int:
        return self._worker_num

    def server_num(self) -> int:
        return len(self._server_endpoints)

    def get_trainer_endpoints(self) -> List[str]:
        return self._worker_endpoints

    def get_pserver_endpoints(self) -> List[str]:
        return self._server_endpoints

    def coordinator_address(self) -> Optional[str]:
        if self._worker_endpoints:
            return self._worker_endpoints[0]
        return None


class PaddleCloudRoleMaker(RoleMakerBase):
    """Env-var driven (reference role_maker.py PaddleCloudRoleMaker)."""

    def __init__(self, is_collective: bool = True):
        super().__init__()
        self._is_collective = is_collective
        self._worker_index = int(os.environ.get("PADDLE_TRAINER_ID", 0))
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._worker_endpoints = [e for e in eps.split(",") if e]
        self._worker_num = max(1, len(self._worker_endpoints)) \
            if self._worker_endpoints else int(os.environ.get("PADDLE_TRAINERS_NUM", 1))
        pservers = os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
        self._server_endpoints = [e for e in pservers.split(",") if e]
        role = os.environ.get("TRAINING_ROLE", "TRAINER").upper()
        self._role = Role.SERVER if role == "PSERVER" else Role.WORKER


class UserDefinedRoleMaker(RoleMakerBase):
    def __init__(self, current_id: int = 0, role: int = Role.WORKER,
                 worker_num: int = 1, server_endpoints: Optional[List[str]] = None,
                 worker_endpoints: Optional[List[str]] = None):
        super().__init__()
        self._worker_index = current_id
        self._role = role
        self._worker_num = worker_num
        self._server_endpoints = server_endpoints or []
        self._worker_endpoints = worker_endpoints or []
