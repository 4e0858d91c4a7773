"""DaemonReplica: a fleet replica backed by a child
``python -m tpu_pbrt_torch.serve`` JSONL daemon — the real-deployment shape
behind the same handle interface ``LocalReplica`` gives the
deterministic tests.

The wire protocol is the daemon's documented one (serve/__main__.py):
one JSON object per line each way, asynchronous ``{"event": ...}``
completion lines interleaved with responses. The router's verbs map
1:1 — submit carries the router-minted trace id in the ``trace`` field
and the router-owned spool path in ``checkpoint``, drain is the
``drain`` verb, health the ``health`` verb. Two deliberate
asymmetries vs LocalReplica:

- the router never steps a daemon (``has_ready`` is always False;
  the child's own loop renders between commands), so ``FleetRouter.
  step()`` only drives in-process replicas;
- job terminality is observed via ``poll``/collected events rather
  than shared objects, and ``kill()`` is a real SIGKILL — process
  death, not a simulation of one.
"""

from __future__ import annotations

import json
import subprocess
import sys
from typing import Any, Dict, List, Optional


class DaemonReplica:
    """Handle on one child serve daemon. `device` is passed on as the
    daemon's --device (CUDA unless it names the CPU)."""

    kind = "daemon"

    def __init__(
        self,
        rid: str,
        *,
        spool_dir: Optional[str] = None,
        seed: int = 0,
        chunk: Optional[int] = None,
        extra_args: Optional[List[str]] = None,
        device: Optional[str] = None,
    ):
        self.rid = rid
        self.alive = True
        self.draining = False
        #: asynchronous {"event": ...} lines collected while waiting
        #: for responses — done/failed completions land here
        self.events: List[Dict[str, Any]] = []
        argv = [sys.executable, "-m", "tpu_pbrt_torch.serve",
                "--seed", str(int(seed))]
        if device:
            argv += ["--device", str(device)]
        if spool_dir:
            argv += ["--spool", spool_dir]
        if chunk:
            argv += ["--chunk", str(int(chunk))]
        argv += list(extra_args or [])
        self.proc = subprocess.Popen(
            argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True, bufsize=1,
        )

    # -- wire --------------------------------------------------------------
    def _rpc(self, req: Dict[str, Any]) -> Dict[str, Any]:
        if not self.alive or self.proc.poll() is not None:
            raise RuntimeError(f"daemon replica {self.rid} is not running")
        self.proc.stdin.write(json.dumps(req) + "\n")
        self.proc.stdin.flush()
        while True:
            line = self.proc.stdout.readline()
            if not line:
                raise RuntimeError(
                    f"daemon replica {self.rid} closed its pipe "
                    f"mid-request ({req.get('op')})"
                )
            msg = json.loads(line)
            if "event" in msg:
                self.events.append(msg)
                continue
            return msg

    # -- submit/lifecycle --------------------------------------------------
    def submit(
        self,
        path: Optional[str] = None,
        *,
        text: Optional[str] = None,
        compiled=None,
        resident_key: Optional[str] = None,
        options=None,
        job_id: Optional[str] = None,
        trace_id: Optional[str] = None,
        checkpoint_path: str = "",
        tenant: str = "default",
        priority: int = 0,
        weight: Optional[float] = None,
        chunk: Optional[int] = None,
        checkpoint_every: int = 0,
        preview_every: int = 0,
        preview_path: str = "",
        outfile: str = "",
    ) -> str:
        if compiled is not None:
            raise ValueError(
                "a compiled (scene, integrator) pair cannot cross a "
                "process boundary — submit a path or inline text"
            )
        req: Dict[str, Any] = {"op": "submit"}
        if path is not None:
            req["scene"] = path
        if text is not None:
            req["text"] = text
        if job_id:
            req["job"] = job_id
        if trace_id:
            req["trace"] = trace_id
        if checkpoint_path:
            req["checkpoint"] = checkpoint_path
        if tenant != "default":
            req["tenant"] = tenant
        if priority:
            req["priority"] = int(priority)
        if weight is not None:
            req["weight"] = weight
        if chunk:
            req["chunk"] = int(chunk)
        if checkpoint_every:
            req["checkpoint_every"] = int(checkpoint_every)
        if preview_every:
            req["preview_every"] = int(preview_every)
        if preview_path:
            req["preview"] = preview_path
        if outfile:
            req["outfile"] = outfile
        if options is not None:
            crop = getattr(options, "crop_window", None)
            if crop:
                req["crop"] = list(crop)
            if getattr(options, "quick_render", False):
                req["quick"] = True
        ans = self._rpc(req)
        if ans.get("shed"):
            from tpu_pbrt_torch.serve.service import ShedError

            raise ShedError(
                f"submit shed: {ans.get('reason', '')}",
                tenant=ans.get("tenant", tenant),
                priority=int(ans.get("priority", priority)),
                reason=ans.get("reason", ""),
            )
        if not ans.get("ok"):
            raise RuntimeError(
                f"daemon replica {self.rid} refused submit: {ans}"
            )
        return ans["job"]

    def poll(self, job_id: str) -> Dict[str, Any]:
        ans = self._rpc({"op": "poll", "job": job_id})
        if not ans.get("ok"):
            raise KeyError(f"unknown job {job_id!r} on {self.rid}: {ans}")
        return ans

    def status(self, job_id: str) -> Optional[str]:
        try:
            return self.poll(job_id).get("status")
        except (KeyError, RuntimeError):
            return None

    def result(self, job_id: str, out: str = "") -> Dict[str, Any]:
        """The daemon's result answer (rays/seconds/mean/stats); `out`
        additionally writes the image file daemon-side."""
        req = {"op": "result", "job": job_id}
        if out:
            req["out"] = out
        ans = self._rpc(req)
        if not ans.get("ok"):
            raise RuntimeError(f"result for {job_id!r} failed: {ans}")
        return ans

    def cancel(self, job_id: str) -> None:
        self._rpc({"op": "cancel", "job": job_id})

    def stats(self) -> Dict[str, Any]:
        ans = self._rpc({"op": "stats"})
        ans.pop("ok", None)
        ans.pop("op", None)
        return ans

    def health(self) -> Dict[str, Any]:
        ans = self._rpc({"op": "health"})
        return {
            "ok": bool(ans.get("ok")) and not ans.get("firing"),
            "firing": list(ans.get("firing", [])),
        }

    # -- scheduling: the child steps itself --------------------------------
    def step(self) -> Optional[str]:
        return None

    def has_ready(self, now: float) -> bool:
        return False

    def backoff_deadlines(self, now: float) -> List[float]:
        return []

    # -- handoff -----------------------------------------------------------
    def drain(self) -> Dict[str, Any]:
        self.draining = True
        return self._rpc({"op": "drain"})

    def kill(self) -> None:
        """SIGKILL — the abrupt-death failover path. The spool keeps
        exactly what the child already checkpointed."""
        self.alive = False
        self.proc.kill()
        self.proc.wait(timeout=10)

    def shutdown(self, drain: bool = True) -> int:
        """Graceful exit: the daemon finishes (drain=True) or abandons
        its queue, then the process ends. Returns the exit code."""
        self.alive = False
        try:
            self.proc.stdin.write(
                json.dumps({"op": "shutdown", "drain": drain}) + "\n"
            )
            self.proc.stdin.flush()
            self.proc.stdin.close()
        except (BrokenPipeError, OSError):
            pass
        return self.proc.wait(timeout=120)
