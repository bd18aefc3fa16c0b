"""Multi-process serving: leader / follower command replication (port of
flexq_tpu/serve/replicated.py).

Under torch.distributed every rank of a mesh is a process, and each forward
of a ``BatchScheduler(mesh=)`` is a collective that every rank must enter
with the same batch. The scheduler is deterministic given one sequence of
(add_request, cancel, step) commands: its draws come from a seeded
generator over logits every rank holds alike, and its host bookkeeping is a
function of the command log. So serving over several ranks reduces to
replicating that log:

  * the LEADER (rank 0, behind the HTTP front end) wraps a BatchScheduler;
    ``add_request`` / ``cancel`` apply locally and buffer the command, and
    each ``step`` first ships the buffered commands and a tick marker to
    every follower over TCP, then steps locally;
  * each FOLLOWER applies the same commands to its own BatchScheduler and
    steps, entering the same collectives. Results surface on the leader.

Wire format: length-prefixed JSON frames (no pickle: a follower executes no
object from the wire), the reference's.

    # leader (rank 0)
    sched = ReplicatedScheduler(BatchScheduler(..., mesh=mesh), leader=True, port=9123,
                                num_followers=world - 1)
    # followers (ranks 1 .. world - 1)
    ReplicatedScheduler(BatchScheduler(..., mesh=mesh), leader=False,
                        leader_addr=("host0", 9123)).serve_forever()

The leader exposes the BatchScheduler surface (add_request / step / run /
has_work and the state the HTTP service reads), so serve/http.py runs on it
unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import socket
import struct
import time
from typing import Callable, Dict, List, Optional, Tuple

from flexq_tpu_torch.serve.sampling import SamplingParams

CONNECT_TIMEOUT_S = 300.0  # how long a leader waits for its followers, and a follower for its leader


def _send_frame(sock: socket.socket, obj) -> None:
    data = json.dumps(obj).encode()
    sock.sendall(struct.pack(">I", len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    data = b""
    while len(data) < n:
        chunk = sock.recv(n - len(data))
        if not chunk:
            raise ConnectionError("leader closed")
        data += chunk
    return data


def _recv_frame(sock: socket.socket):
    (n,) = struct.unpack(">I", _recv_exact(sock, 4))
    return json.loads(_recv_exact(sock, n))


def _sampling_to_json(s: SamplingParams) -> Dict:
    return dataclasses.asdict(s)


def _sampling_from_json(d: Dict) -> SamplingParams:
    return SamplingParams(**d)


class ReplicatedScheduler:
    """Command-log replication around a BatchScheduler (see the module
    docstring). ``announce``, on the leader, is called with the bound port
    before the followers are awaited (``port=0`` binds a free one)."""

    def __init__(
        self,
        scheduler,
        leader: bool,
        port: int = 0,
        num_followers: int = 0,
        leader_addr: Optional[Tuple[str, int]] = None,
        host: str = "0.0.0.0",
        announce: Optional[Callable[[int], None]] = None,
    ):
        self.scheduler = scheduler
        self.leader = leader
        self._pending_cmds: List[Dict] = []
        self._followers: List[socket.socket] = []
        self._sock: Optional[socket.socket] = None
        self.port: Optional[int] = None
        if leader:
            if num_followers > 0:
                srv = socket.socket()
                srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                srv.bind((host, port))
                srv.listen(num_followers)
                srv.settimeout(CONNECT_TIMEOUT_S)
                self.port = srv.getsockname()[1]
                if announce is not None:
                    announce(self.port)
                for _ in range(num_followers):
                    conn, _ = srv.accept()
                    conn.settimeout(None)
                    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                    self._followers.append(conn)
                srv.close()
        else:
            if leader_addr is None:
                raise ValueError("a follower needs leader_addr")
            deadline = time.monotonic() + CONNECT_TIMEOUT_S
            while True:  # the leader may still be binding its port
                try:
                    s = socket.create_connection(leader_addr, timeout=CONNECT_TIMEOUT_S)
                    break
                except OSError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.2)
            s.settimeout(None)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s

    # ---- leader surface (BatchScheduler's) --------------------------------
    def add_request(self, prompt, sampling: SamplingParams = SamplingParams(), max_new_tokens: int = 64,
                    eos_id: int = 2, logprobs: bool = False, beam_width: int = 1, n_best: int = 1,
                    length_penalty: float = 1.0) -> int:
        if not self.leader:
            raise RuntimeError("only the leader accepts requests")
        cmd = {
            "op": "add",
            "prompt": [int(t) for t in prompt],
            "sampling": _sampling_to_json(sampling),
            "max_new_tokens": int(max_new_tokens),
            "eos_id": int(eos_id),
            "logprobs": bool(logprobs),
            "beam_width": int(beam_width),
            "n_best": int(n_best),
            "length_penalty": float(length_penalty),
        }
        # the local add assigns the id (and may refuse the request, which
        # is then not logged); followers assign the same ids in log order
        rid = self._apply_add(self.scheduler, cmd)
        self._pending_cmds.append(cmd)
        return rid

    @staticmethod
    def _apply_add(scheduler, cmd) -> int:
        return scheduler.add_request(
            cmd["prompt"], sampling=_sampling_from_json(cmd["sampling"]), max_new_tokens=cmd["max_new_tokens"],
            eos_id=cmd["eos_id"], logprobs=cmd["logprobs"], beam_width=cmd["beam_width"], n_best=cmd["n_best"],
            length_penalty=cmd["length_penalty"],
        )

    def cancel(self, req_id: int) -> Optional[List[int]]:
        """A replicated cancel (a leader-only one would fork the followers'
        host state)."""
        if not self.leader:
            raise RuntimeError("only the leader cancels")
        self._pending_cmds.append({"op": "cancel", "req_id": int(req_id)})
        return self.scheduler.cancel(req_id)

    def shed_beam(self) -> bool:
        """Pool-exhaustion escape hatch, not logged: a follower replaying
        the same tick hits the same MemoryError and sheds the same group
        itself (``serve_forever``)."""
        return self.scheduler.shed_beam()

    def step(self) -> Dict[int, List[int]]:
        if not self.leader:
            raise RuntimeError("followers step in serve_forever")
        frame = {"op": "tick", "cmds": self._pending_cmds}
        for f in self._followers:
            _send_frame(f, frame)
        self._pending_cmds = []
        return self.scheduler.step()

    def run(self) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        while self.has_work:
            out.update(self.step())
        return out

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work

    def __getattr__(self, name):
        # the scheduler's state the HTTP service reads (slots, pending,
        # done_logprobs, pool, ...): the leader's replica
        if name == "scheduler":
            raise AttributeError(name)
        return getattr(self.scheduler, name)

    def shutdown(self) -> None:
        for f in self._followers:
            try:
                _send_frame(f, {"op": "shutdown"})
                f.close()
            except OSError:
                pass
        self._followers = []

    # ---- follower loop ----------------------------------------------------
    def serve_forever(self) -> None:
        """Mirror the leader's command log until it shuts down: each tick
        applies the commands, then steps, entering the collectives the
        leader's step enters."""
        if self.leader:
            raise RuntimeError("serve_forever is the followers' loop")
        while True:
            frame = _recv_frame(self._sock)
            if frame["op"] == "shutdown":
                self._sock.close()
                return
            if frame["op"] != "tick":
                raise ValueError(f"unknown frame {frame['op']!r}")
            for cmd in frame["cmds"]:
                if cmd["op"] == "cancel":
                    self.scheduler.cancel(cmd["req_id"])
                else:
                    self._apply_add(self.scheduler, cmd)
            try:
                self.scheduler.step()
            except MemoryError:
                # the leader's worker sheds on the same error from the same state
                self.scheduler.shed_beam()
