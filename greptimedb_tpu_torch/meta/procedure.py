"""Procedure framework: persistent, resumable multi-step state machines.

Equivalent of the reference's common-procedure crate
(src/common/procedure/src/procedure.rs:37,194 + local.rs journaling, RFC
2023-01-03-procedure-framework): every DDL/migration step persists its
state to the kv store before executing, so a crashed coordinator resumes
exactly where it stopped; poison keys mark procedures that died on
corrupted state so they are not blindly retried (procedure.rs:37-91).
"""

from __future__ import annotations

import enum
import json
import time
import uuid
from dataclasses import dataclass

from greptimedb_tpu_torch.errors import GreptimeError
from greptimedb_tpu_torch.meta.kv import KvBackend


class ProcedureState(enum.Enum):
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"
    POISONED = "poisoned"


@dataclass
class Status:
    """Result of one execute step."""

    kind: str  # "executing" | "done" | "poison"
    persist: bool = True
    output: object = None

    @staticmethod
    def executing(persist: bool = True) -> "Status":
        return Status("executing", persist)

    @staticmethod
    def done(output: object = None) -> "Status":
        return Status("done", output=output)

    @staticmethod
    def poison() -> "Status":
        return Status("poison")


class Procedure:
    """Subclass contract: ``type_name`` registered with the manager;
    ``state`` is a json-serializable dict mutated by execute(); execute()
    advances one step per call and returns a Status."""

    type_name = "procedure"

    def __init__(self, state: dict | None = None):
        self.state = state or {}

    def execute(self, ctx: "ProcedureContext") -> Status:
        raise NotImplementedError

    def lock_keys(self) -> list[str]:
        """Exclusive keys (reference DDL key locks, rwlock.rs)."""
        return []


@dataclass
class ProcedureContext:
    kv: KvBackend
    manager: "ProcedureManager"
    procedure_id: str
    # host services a procedure may touch (datanodes, catalog...) are
    # injected by the embedding application
    services: dict = None


class ProcedureManager:
    """Journaled executor (reference LocalManager + StateStore)."""

    _PREFIX = "__procedure/"

    def __init__(self, kv: KvBackend, services: dict | None = None):
        import threading

        self.kv = kv
        self.services = services or {}
        self._registry: dict[str, type[Procedure]] = {}
        self._locks: set[str] = set()
        # guards check-and-acquire of lock keys: standalone serializes DDL
        # behind the db lock, but the manager must be safe on its own
        # (metasrv handlers, direct submit() from tests/tools)
        self._locks_mu = threading.Lock()

    def register(self, cls: type[Procedure]) -> None:
        self._registry[cls.type_name] = cls

    # ------------------------------------------------------------------
    def _journal_key(self, pid: str) -> str:
        return f"{self._PREFIX}{pid}"

    def _poison_key(self, key: str) -> str:
        return f"__poison/{key}"

    def submit(self, proc: Procedure, max_steps: int = 1000) -> object:
        """Run a procedure to completion, journaling every step. Returns
        the final output; raises on failure after journaling FAILED."""
        pid = uuid.uuid4().hex
        return self._drive(pid, proc, max_steps)

    def _drive(self, pid: str, proc: Procedure, max_steps: int) -> object:
        key = self._journal_key(pid)
        locks = proc.lock_keys()
        for lk in locks:
            if self.kv.get(self._poison_key(lk)) is not None:
                raise GreptimeError(
                    f"resource {lk} is poisoned by a failed procedure"
                )
        with self._locks_mu:  # atomic check-and-acquire of ALL keys
            busy = [lk for lk in locks if lk in self._locks]
            if busy:
                raise GreptimeError(f"procedure lock busy: {busy[0]}")
            self._locks.update(locks)
        try:
            ctx = ProcedureContext(self.kv, self, pid, self.services)
            # write-ahead journal BEFORE the first step: a crash during step 1
            # must leave a RUNNING record for recover() to resume
            self.kv.put_json(key, {
                "type": proc.type_name, "state": proc.state,
                "status": ProcedureState.RUNNING.value, "ts": time.time(),
            })
            step = 0
            while step < max_steps:
                step += 1
                try:
                    status = proc.execute(ctx)
                except Exception as e:  # noqa: BLE001
                    self.kv.put_json(key, {
                        "type": proc.type_name, "state": proc.state,
                        "status": ProcedureState.FAILED.value,
                        "error": str(e), "ts": time.time(),
                    })
                    raise
                if status.kind == "poison":
                    for lk in locks:
                        self.kv.put_json(self._poison_key(lk), {"pid": pid})
                    self.kv.put_json(key, {
                        "type": proc.type_name, "state": proc.state,
                        "status": ProcedureState.POISONED.value, "ts": time.time(),
                    })
                    raise GreptimeError(f"procedure {proc.type_name} poisoned")
                if status.persist or status.kind == "done":
                    self.kv.put_json(key, {
                        "type": proc.type_name, "state": proc.state,
                        "status": (
                            ProcedureState.DONE.value if status.kind == "done"
                            else ProcedureState.RUNNING.value
                        ),
                        "ts": time.time(),
                    })
                if status.kind == "done":
                    self._prune_finished()
                    return status.output
            raise GreptimeError(f"procedure {proc.type_name} exceeded {max_steps} steps")
        finally:
            with self._locks_mu:
                for lk in locks:
                    self._locks.discard(lk)

    def _prune_finished(self, keep: int = 200) -> None:
        """Bound journal growth: now that every DDL is a procedure, keep
        only the most recent finished (DONE/FAILED) journals for
        information_schema.procedure_info; RUNNING/POISONED stay."""
        finished = []
        for k, raw in self.kv.range(self._PREFIX):
            rec = json.loads(raw)
            if rec.get("status") in (ProcedureState.DONE.value,
                                     ProcedureState.FAILED.value):
                finished.append((rec.get("ts", 0), k))
        if len(finished) > keep:
            finished.sort()
            for _ts, k in finished[:len(finished) - keep]:
                self.kv.delete(k)

    # ------------------------------------------------------------------
    def recover(self) -> list[object]:
        """Resume procedures journaled RUNNING (coordinator restart path).
        Returns outputs of resumed procedures. One failing resume must not
        starve the rest — with every DDL journaled, several RUNNING
        journals after a crash are normal; failures stay journaled FAILED
        and the first error is re-raised only after all were attempted."""
        out = []
        first_err: Exception | None = None
        for k, raw in self.kv.range(self._PREFIX):
            rec = json.loads(raw)
            if rec["status"] != ProcedureState.RUNNING.value:
                continue
            cls = self._registry.get(rec["type"])
            if cls is None:
                # an unknown type must never stay RUNNING forever: its
                # half-applied state would never converge (the chaos
                # fuzzer caught exactly this for an unregistered class).
                # Journal it FAILED so operators see it in
                # information_schema.procedure_info instead of a
                # permanent stuck runner.
                rec["status"] = ProcedureState.FAILED.value
                rec["error"] = f"type {rec['type']!r} not registered"
                self.kv.put_json(k, rec)
                if first_err is None:
                    first_err = GreptimeError(rec["error"])
                continue
            proc = cls(state=rec["state"])
            pid = k[len(self._PREFIX):]
            try:
                out.append(self._drive(pid, proc, max_steps=1000))
            except Exception as e:  # noqa: BLE001
                # _drive journals FAILED for step errors, but pre-step
                # rejections (poisoned lock, lock busy) raise BEFORE any
                # journal write — finalize here so no record stays RUNNING
                cur = json.loads(self.kv.get(k) or b"{}")
                if cur.get("status") == ProcedureState.RUNNING.value:
                    cur["status"] = ProcedureState.FAILED.value
                    cur["error"] = str(e)
                    self.kv.put_json(k, cur)
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err
        return out

    def history(self) -> list[dict]:
        return [json.loads(v) for _k, v in self.kv.range(self._PREFIX)]

    def clear_poison(self, key: str) -> None:
        self.kv.delete(self._poison_key(key))
