"""Role makers (`paddle_tpu/distributed/fleet/base/role_maker.py`;
reference `python/paddle/distributed/fleet/base/role_maker.py`): whether
this process is a WORKER or a SERVER and where its peers are, read from the
PaddleCloud environment (PADDLE_TRAINERS_NUM, TRAINING_ROLE, PADDLE_PORT,
POD_IP, PADDLE_PSERVERS_IP_PORT_LIST, PADDLE_TRAINER_ID,
PADDLE_TRAINER_ENDPOINTS) or given by the caller."""

from __future__ import annotations

import os

__all__ = ["Role", "PaddleCloudRoleMaker", "UserDefinedRoleMaker"]


class Role:
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4
    COORDINATOR = 5


class PaddleCloudRoleMaker:
    """Resolve the role from PaddleCloud-style env vars (reference
    PaddleCloudRoleMaker._ps_env / _collective_env)."""

    def __init__(self, is_collective=False, **kwargs):
        self._is_collective = is_collective
        self._kwargs = kwargs
        self._generated = False
        self._role = Role.WORKER
        self._current_id = 0
        self._worker_num = 1
        self._server_endpoints = []
        self._worker_endpoints = []

    def _generate_role(self):
        if self._generated:
            return
        env = os.environ
        if self._is_collective:
            self._role = Role.WORKER
            self._current_id = int(env.get("PADDLE_TRAINER_ID", 0))
            eps = env.get("PADDLE_TRAINER_ENDPOINTS", "")
            self._worker_endpoints = eps.split(",") if eps else []
            self._worker_num = int(
                env.get("PADDLE_TRAINERS_NUM",
                        len(self._worker_endpoints) or 1))
        else:
            training_role = env.get("TRAINING_ROLE", "TRAINER")
            eps = env.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
            self._server_endpoints = eps.split(",") if eps else []
            self._worker_num = int(env.get("PADDLE_TRAINERS_NUM", 1))
            if training_role == "TRAINER":
                self._role = Role.WORKER
                self._current_id = int(env.get("PADDLE_TRAINER_ID", 0))
            elif training_role == "PSERVER":
                self._role = Role.SERVER
                me = (env.get("POD_IP", "127.0.0.1") + ":"
                      + env.get("PADDLE_PORT", "0"))
                self._current_id = (self._server_endpoints.index(me)
                                    if me in self._server_endpoints else 0)
            else:
                raise ValueError(
                    f"TRAINING_ROLE must be TRAINER or PSERVER, got "
                    f"{training_role!r}")
        self._generated = True

    def _is_worker(self):
        self._generate_role()
        return self._role == Role.WORKER

    is_worker = _is_worker

    def _is_server(self):
        self._generate_role()
        return self._role == Role.SERVER

    is_server = _is_server

    def _is_first_worker(self):
        return self._is_worker() and self._worker_index() == 0

    is_first_worker = _is_first_worker

    def _worker_index(self):
        self._generate_role()
        return self._current_id

    worker_index = _worker_index

    def _server_index(self):
        self._generate_role()
        return self._current_id

    server_index = _server_index

    def worker_num(self):
        self._generate_role()
        return self._worker_num

    def server_num(self):
        self._generate_role()
        return len(self._server_endpoints) or 0

    def get_pserver_endpoints(self):
        self._generate_role()
        return list(self._server_endpoints)

    def get_trainer_endpoints(self):
        self._generate_role()
        return list(self._worker_endpoints)


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    """Role passed explicitly instead of via env (reference
    UserDefinedRoleMaker)."""

    def __init__(self, is_collective=False, init_gloo=False, **kwargs):
        super().__init__(is_collective=is_collective, **kwargs)
        self._role = kwargs.get("role", Role.WORKER)
        self._current_id = kwargs.get("current_id", 0)
        self._worker_num = kwargs.get("worker_num", 1)
        self._server_endpoints = list(kwargs.get("server_endpoints", []))
        self._worker_endpoints = list(kwargs.get("worker_endpoints", []))
        self._generated = True
