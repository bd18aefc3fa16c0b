"""HTTP service over the continuous-batching scheduler (port of
flexq_tpu/serve/http.py: the same endpoints, bodies and answers).

A stdlib-only JSON API in front of ``BatchScheduler``: handler threads
admit requests into the scheduler; one worker thread runs its ticks, so
requests from many connections decode together.

API:
  GET  /health            -> {"ok": true, "slots": N, "active": A, "pending": M}
  GET  /metrics           -> request / token counters, tok/s, slot occupancy,
                             queue depth, admission counters, the worker's
                             failed ticks, pages free (paged) and prefix hits
  GET  /v1/models         -> OpenAI-style model listing
  POST /generate          body: {"prompt_ids": [int...], "max_new_tokens",
                                 sampling overrides, "eos_id", "logprobs",
                                 "beam_width", "n_best", "length_penalty"}
                          -> {"request_id", "tokens"[, "logprobs",
                              "cum_logprob"][, "nbest"]}
  POST /v1/completions    OpenAI-compatible: prompt = str | [int] | a list of
                          those; n, max_tokens, temperature (0 = greedy),
                          top_p, stop, logprobs, echo, stream (SSE chunks of
                          text deltas and their token_ids, holding back an
                          incomplete UTF-8 tail and a possible stop prefix);
                          best_of > n or use_beam_search: n choices of a
                          best_of-beam search (each with its beam_score)
  POST /v1/chat/completions  messages=[{role, content}...] through the
                          tokenizer's chat template; stream supported

Admission control (--max-pending / --queue-timeout): a full pending queue
answers 429 with Retry-After; a request shed after waiting past the queue
timeout answers 503.

Run:  python -m flexq_tpu_torch.serve.http --checkpoint <packed dir> [--paged]
(see main()); tests drive it in-process through serve_background().

Tensor / data parallel (--tp / --dp): one process per rank, each given the
rendezvous (--coordinator host:port of rank 0, --num-processes, --process-id;
parallel/distributed.py; over several nodes, LOCAL_WORLD_SIZE set to the
ranks of each node). Rank 0 serves HTTP over a leader
ReplicatedScheduler (serve/replicated.py), which ships each tick's commands
to the other ranks on --replication-port; they follow. A ``--tp N`` export
is read rank by rank (load_packed_sharded); a checkpoint exported at
another tp is refused. On one card with two ranks: --backend gloo and
--fused-tick 0 (gloo's collectives go through the host and cannot be
captured in the step graph):

    python -m flexq_tpu_torch.serve.http --checkpoint ckpt_tp2 --tp 2 --backend gloo --fused-tick 0 \\
        --coordinator 127.0.0.1:29500 --num-processes 2 --process-id 0 --port 8000 &
    python -m flexq_tpu_torch.serve.http --checkpoint ckpt_tp2 --tp 2 --backend gloo --fused-tick 0 \\
        --coordinator 127.0.0.1:29500 --num-processes 2 --process-id 1

Pipeline parallel (--pp N, exclusive with --tp / --dp): one process per
stage, the same flags; each stage reads the whole packed checkpoint on the
host and keeps its L/N layers; a dense cache, and --fused-tick forced to 0
(as in the reference):

    python -m flexq_tpu_torch.serve.http --checkpoint ckpt --pp 2 --backend gloo \\
        --coordinator 127.0.0.1:29500 --num-processes 2 --process-id 0 --port 8000 &
    python -m flexq_tpu_torch.serve.http --checkpoint ckpt --pp 2 --backend gloo \\
        --coordinator 127.0.0.1:29500 --num-processes 2 --process-id 1
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from flexq_tpu_torch.serve.sampling import SamplingParams


class QueueFull(Exception):
    """Admission rejected: the pending queue is at max_pending."""


class SchedulerService:
    """Thread-safe wrapper: one worker thread drives scheduler.step();
    callers block on per-request events.

    Admission control (the piece FT's static batching never needed):
      * ``max_pending`` bounds the pending queue — submits past it raise
        QueueFull, which the HTTP layer maps to 429 + Retry-After, so
        saturation sheds load instead of growing an unbounded deque with
        unbounded TTFT (measured: 3 req/s over capacity drove TTFT p99 to
        5.7 s with no bound).
      * ``queue_timeout_s`` sheds requests that waited in the queue longer
        than the bound without being admitted (503 to the client) — a
        client-visible promise that admitted work starts decoding within
        the timeout.

    A tick that raises is caught, its traceback printed and counted in
    ``failed_ticks`` (``worker_failed_ticks`` in /metrics), and the worker
    keeps serving; after five failures in a row it surfaces every
    request's tokens so far and drops the stuck work.
    """

    def __init__(self, scheduler, poll_idle_s: float = 0.002,
                 max_pending: Optional[int] = None,
                 queue_timeout_s: Optional[float] = None):
        self.scheduler = scheduler
        self._lock = threading.Lock()
        self._events: Dict[int, threading.Event] = {}
        self._results: Dict[int, List[int]] = {}
        self._poll_idle_s = poll_idle_s
        self._stop = False
        self._waiting_ops = 0  # submit/cancel callers waiting on the lock
        self._ops_lock = threading.Lock()  # += is not atomic across threads
        self._t0 = time.monotonic()
        self._requests_done = 0
        self._tokens_out = 0
        self._steps = 0
        self.max_pending = max_pending
        self.queue_timeout_s = queue_timeout_s
        self._enqueue_t: Dict[int, float] = {}  # rid -> submit monotonic
        self._shed_rids: set = set()
        self._rejected_total = 0
        self._shed_total = 0
        self.failed_ticks = 0  # ticks whose step raised (the worker survives them)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _run(self):
        fail_streak = 0
        while not self._stop:
            had_work = False
            try:
                with self._lock:
                    if self.queue_timeout_s is not None:
                        self._shed_overdue_locked()
                    had_work = self.scheduler.has_work
                    if had_work:
                        finished = self.scheduler.step()
                        self._steps += 1
                        lps = self.scheduler.done_logprobs
                        nbs = self.scheduler.done_nbest
                        for rid, toks in finished.items():
                            self._results[rid] = (
                                toks, lps.pop(rid, None), nbs.pop(rid, None)
                            )
                            self._enqueue_t.pop(rid, None)
                            self._requests_done += 1
                            self._tokens_out += len(toks)
                            ev = self._events.get(rid)
                            if ev is not None:
                                ev.set()
                fail_streak = 0
            except Exception:
                # a dead worker thread would hang every current and future
                # request until timeout — degrade instead of dying. The
                # reachable case is pool exhaustion with only beam lanes
                # left (beams are never preempted): shed the youngest beam
                # group and keep ticking.
                import traceback

                traceback.print_exc()
                fail_streak += 1
                self.failed_ticks += 1
                with self._lock:
                    shed = self.scheduler.shed_beam()
                replicated = hasattr(self.scheduler, "_pending_cmds")
                if not shed and fail_streak >= 5 and not replicated:
                    # persistent failure: surface partial results so
                    # clients unblock, then drop the stuck work. (On a
                    # replicated leader this deep wipe would fork the
                    # followers — there we only retry + shed, which IS
                    # mirrored deterministically.)
                    with self._lock:

                        def surface(rid, toks):
                            self._results[rid] = (toks, None, None)
                            ev = self._events.get(rid)
                            if ev is not None:
                                ev.set()

                        # completed inside the failing tick but not returned
                        done = self.scheduler.done
                        for rid, toks in list(done.items()):
                            surface(rid, list(toks))
                        done.clear()
                        groups = self.scheduler.beam_groups
                        for g in list(groups.values()):
                            surface(g.req_id, list(g.histories[0]))
                            if self.scheduler.paged:
                                # lanes share pages: free the unique set
                                # once (per-slot release would double-free)
                                try:
                                    freed = set(
                                        self.scheduler._beam_page_rc(g)
                                    )
                                    for i2 in g.slots:
                                        self.scheduler.ptable.release(i2)
                                    self.scheduler.pool.free(freed)
                                except Exception:
                                    pass
                            for i2 in g.slots:
                                self.scheduler.slots[i2] = type(
                                    self.scheduler.slots[i2]
                                )()
                        groups.clear()
                        for s in list(self.scheduler.slots):
                            if s.req_id is not None and not s.beam:
                                surface(
                                    s.req_id,
                                    list(s.prior) + list(s.generated),
                                )
                        for pnd in list(self.scheduler.pending):
                            surface(pnd.req_id, list(pnd.prior))
                        self.scheduler.pending.clear()
                        for i in range(len(self.scheduler.slots)):
                            if self.scheduler.paged:
                                try:
                                    self.scheduler._release_slot_pages(i)
                                except Exception:
                                    pass  # page leak beats a dead server
                            self.scheduler.slots[i] = type(
                                self.scheduler.slots[i]
                            )()
                    fail_streak = 0
                time.sleep(0.05)
            if self._waiting_ops:
                # back-to-back re-acquisition starves submit/cancel callers
                # (threading.Lock is not fair): yield for one beat so a
                # waiting admission gets in before the next tick
                time.sleep(0.001)
            elif not had_work:
                time.sleep(self._poll_idle_s)

    def _shed_overdue_locked(self):
        """Drop pending requests older than queue_timeout_s (caller holds
        the lock). The waiter is unblocked with a result flagged shed so
        the HTTP layer answers 503 instead of an empty completion."""
        now = time.monotonic()
        for p in list(self.scheduler.pending):
            rid = p.req_id
            t0 = self._enqueue_t.get(rid)
            if t0 is None or now - t0 <= self.queue_timeout_s:
                continue
            dropped = self.scheduler.cancel(rid)
            self._enqueue_t.pop(rid, None)
            self._shed_rids.add(rid)
            self._shed_total += 1
            self._results[rid] = (dropped if dropped is not None else [], None, None)
            ev = self._events.get(rid)
            if ev is not None:
                ev.set()

    def submit(self, prompt, sampling: SamplingParams, max_new: int, eos_id: int,
               logprobs: bool = False, beam_width: int = 1, n_best: int = 1,
               length_penalty: float = 1.0) -> int:
        with self._ops_lock:
            self._waiting_ops += 1
        try:
            with self._lock:
                if (
                    self.max_pending is not None
                    and len(self.scheduler.pending) >= self.max_pending
                ):
                    self._rejected_total += 1
                    raise QueueFull(
                        f"pending queue full ({self.max_pending}); retry later"
                    )
                rid = self.scheduler.add_request(
                    prompt, sampling=sampling, max_new_tokens=max_new, eos_id=eos_id,
                    logprobs=logprobs, beam_width=beam_width, n_best=n_best,
                    length_penalty=length_penalty,
                )
                self._events[rid] = threading.Event()
                self._enqueue_t[rid] = time.monotonic()
            return rid
        finally:
            with self._ops_lock:
                self._waiting_ops -= 1

    def was_shed(self, rid: int) -> bool:
        """True (once) if rid was dropped by the queue timeout."""
        with self._lock:
            if rid in self._shed_rids:
                self._shed_rids.discard(rid)
                return True
            return False

    def wait(self, rid: int, timeout: Optional[float] = None) -> List[int]:
        toks, _ = self.wait_full(rid, timeout)
        return toks

    def wait_full(self, rid: int, timeout: Optional[float] = None):
        """Returns (tokens, logprobs-or-None)."""
        toks, lps, _ = self._wait(rid, timeout)
        return toks, lps

    def wait_nbest(self, rid: int, timeout: Optional[float] = None):
        """Returns (best tokens, ranked [(tokens, score)] or None)."""
        toks, _, nbest = self._wait(rid, timeout)
        return toks, nbest

    def _wait(self, rid: int, timeout: Optional[float]):
        ev = self._events[rid]
        if not ev.wait(timeout):
            raise TimeoutError(f"request {rid} not finished")
        with self._lock:
            self._events.pop(rid, None)
            return self._results.pop(rid)

    def peek(self, rid: int):
        """(tokens so far, finished?) without consuming the result —
        the polling primitive behind SSE streaming.

        LOCK-FREE by design: streaming handlers poll this every ~5 ms, and
        contending with the worker's back-to-back ticks delayed chunks by
        whole generations (the lock is not fair). Every read here is a
        benign race under the GIL: generated/prior are append-only lists
        (list() snapshots atomically), slot objects are swapped atomically
        on reset, and a request finishing between the two checks is caught
        by the second _results lookup."""
        res = self._results.get(rid)
        if res is not None:
            return list(res[0]), True
        for s in self.scheduler.slots:
            if s.req_id == rid:
                return list(s.prior) + list(s.generated), False
        res = self._results.get(rid)  # finished between the two checks
        if res is not None:
            return list(res[0]), True
        return [], False  # still pending admission

    def cancel(self, rid: int):
        """Best-effort early stop (client disconnected / stop string hit).
        Pending requests are dropped immediately; a decoding slot has its
        budget clamped so it finishes on the next recorded token."""
        with self._ops_lock:
            self._waiting_ops += 1
        try:
            self._cancel_locked(rid)
        finally:
            with self._ops_lock:
                self._waiting_ops -= 1

    def _cancel_locked(self, rid: int):
        with self._lock:
            self._enqueue_t.pop(rid, None)
            dropped = self.scheduler.cancel(rid)
            if dropped is not None:  # was still pending: surface the result
                self._results[rid] = (dropped, None, None)
                ev = self._events.get(rid)
                if ev is not None:
                    ev.set()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "slots": self.scheduler.num_slots,
                "active": sum(
                    1 for s in self.scheduler.slots if s.req_id is not None
                ),
                "pending": len(self.scheduler.pending),
            }

    def metrics(self) -> Dict[str, float]:
        up = max(time.monotonic() - self._t0, 1e-9)
        with self._lock:
            m = {
                "uptime_s": round(up, 3),
                "requests_completed": self._requests_done,
                "tokens_generated": self._tokens_out,
                "decode_steps": self._steps,
                "tokens_per_s_lifetime": round(self._tokens_out / up, 3),
                **{f"slots_{k}": v for k, v in (
                    ("total", self.scheduler.num_slots),
                    ("active", sum(1 for s in self.scheduler.slots if s.req_id is not None)),
                )},
                "pending": len(self.scheduler.pending),
                "queue_depth": len(self.scheduler.pending),
                "admission_rejected_total": self._rejected_total,
                "queue_shed_total": self._shed_total,
                "worker_failed_ticks": self.failed_ticks,
            }
            if self.max_pending is not None:
                m["max_pending"] = self.max_pending
            if getattr(self.scheduler, "paged", False):
                m["pages_free"] = self.scheduler.pool.free_pages
                m["pages_total"] = self.scheduler.pool.num_pages
            reg = getattr(self.scheduler, "registry", None)
            if reg is not None:
                m["prefix_pages_hit"] = reg.hits
                m["prefix_pages_missed"] = reg.misses
                m["prefix_pages_retained"] = reg.reclaimable
            return m

    def shutdown(self):
        self._stop = True
        self._worker.join(timeout=5)


class QueueTimeout(Exception):
    """Request shed after waiting in the pending queue past the bound."""


def _first_stop_hit(text: str, stops: List[str]):
    """Earliest stop-string occurrence in text, or None."""
    best = None
    for s in stops:
        i = text.find(s)
        if i >= 0 and (best is None or i < best):
            best = i
    return best


def _stream_safe_len(text: str, stops: List[str]) -> int:
    """Emittable prefix length of not-yet-final streamed text.

    Holds back (a) trailing replacement chars — an incomplete multi-byte
    UTF-8 sequence decodes to U+FFFD under errors='replace' and would be
    emitted corrupted before its continuation byte arrives — and (b) the
    longest suffix that is a proper prefix of some stop string (emitting
    'EN' of stop='END' early would leak text past the stop cut that the
    non-streaming path truncates). Both are flushed once disambiguated or
    at stream end (the vLLM/OpenAI server buffering rule).
    """
    n = len(text)
    while n and text[n - 1] == "�":
        n -= 1
    safe = n
    for s in stops:
        for j in range(min(len(s) - 1, n), 0, -1):
            if text[:n].endswith(s[:j]):
                safe = min(safe, n - j)
                break
    return safe


def _cut_token_ids(tokenizer, toks: List[int], text_len: int) -> List[int]:
    """Largest token prefix whose decoded text fits within text_len chars —
    keeps choice token_ids/logprobs consistent with stop-truncated text."""
    if text_len <= 0:
        return []
    for i in range(len(toks)):
        if len(tokenizer.decode(toks[: i + 1])) > text_len:
            return toks[:i]
    return list(toks)


def _make_handler(service: SchedulerService, tokenizer=None,
                  model_name: str = "flexq-tpu"):
    if tokenizer is None:
        from flexq_tpu_torch.serve.tokenizer import ByteTokenizer

        tokenizer = ByteTokenizer()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, payload: dict, headers: dict = None):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send_429(self, e):
            self._send(429, {"error": {"message": str(e),
                                       "type": "rate_limit_error"}},
                       headers={"Retry-After": "1"})

        def _send_503(self, e):
            self._send(503, {"error": {"message": str(e),
                                       "type": "overloaded_error"}})

        def _rollback(self, rids):
            """Cancel + drain requests submitted before a QueueFull aborted
            the batch, so their results/events don't leak."""
            for rid in rids:
                service.cancel(rid)
                try:
                    service.wait_full(rid, timeout=600)
                except (TimeoutError, KeyError):
                    pass

        def do_GET(self):
            if self.path == "/health":
                self._send(200, {"ok": True, **service.stats()})
            elif self.path == "/metrics":
                self._send(200, service.metrics())
            elif self.path == "/v1/models":
                self._send(200, {"object": "list", "data": [
                    {"id": model_name, "object": "model", "owned_by": "flexq-tpu"}
                ]})
            else:
                self._send(404, {"error": "not found"})

        # ---- OpenAI-compatible endpoints -------------------------------

        def _encode_prompt(self, p):
            """str -> tokenized ids; [int] -> as-is. Returns (ids, text?)."""
            if isinstance(p, str):
                return tokenizer.encode(p), p
            if isinstance(p, list) and all(
                isinstance(t, int) and not isinstance(t, bool) for t in p
            ):
                return [int(t) for t in p], None
            raise ValueError("prompt must be a string or a list of token ids")

        def _openai_common(self, req):
            temperature = float(req.get("temperature", 1.0))
            sampling = SamplingParams(
                temperature=temperature if temperature > 0 else 1.0,
                top_k=int(req.get("top_k", 0)),
                top_p=float(req.get("top_p", 1.0)),
                repetition_penalty=float(req.get("repetition_penalty", 1.0)),
                greedy=temperature <= 0,
            )
            stop = req.get("stop") or []
            if isinstance(stop, str):
                stop = [stop]
            max_new = int(req.get("max_tokens", 16))
            eos_id = int(req.get("eos_id", getattr(tokenizer, "eos_id", 2)))
            return sampling, [str(s) for s in stop], max_new, eos_id

        def _finish(self, toks, eos_id, max_new):
            if toks and toks[-1] == eos_id:
                return toks[:-1], "stop"
            return toks, "length" if len(toks) >= max_new else "stop"

        def _openai_completions(self, req):
            sampling, stops, max_new, eos_id = self._openai_common(req)
            p = req.get("prompt", "")
            prompts = (
                p if isinstance(p, list) and p and isinstance(p[0], (str, list))
                else [p]
            )
            n = int(req.get("n", 1))
            want_lp = req.get("logprobs") not in (None, False)
            echo = bool(req.get("echo", False))
            # beam search: best_of > n (OpenAI semantics: best_of candidates,
            # top n returned) or an explicit use_beam_search flag (vLLM
            # convention) routes through the scheduler's beam path
            best_of = int(req.get("best_of", n))
            if best_of > n or bool(req.get("use_beam_search", False)):
                return self._beam_completions(
                    req, prompts, n, max(best_of, n, 2), stops, max_new,
                    eos_id, echo, want_lp,
                )
            if bool(req.get("stream", False)):
                if len(prompts) != 1 or n != 1:
                    raise ValueError("stream=true supports a single prompt, n=1")
                if echo or want_lp:
                    raise ValueError(
                        "stream=true does not support echo/logprobs"
                    )
                ids, _ = self._encode_prompt(prompts[0])
                self._stream(ids, sampling, stops, max_new, eos_id,
                             mode="text_completion")
                return None
            subs = []  # (rid, prompt_ids, prompt_text)
            ptoks = 0
            try:
                for prm in prompts:
                    ids, text = self._encode_prompt(prm)
                    ptoks += len(ids)  # distinct prompt counted ONCE, not xn
                    for _ in range(n):
                        rid = service.submit(ids, sampling, max_new, eos_id,
                                             logprobs=want_lp)
                        subs.append((rid, ids, text))
            except QueueFull:
                self._rollback([rid for rid, _, _ in subs])
                raise
            choices, ctoks = [], 0
            shed = False
            timeout = float(req.get("timeout", 600))
            for idx, (rid, ids, text) in enumerate(subs):
                toks, lps = service.wait_full(rid, timeout)
                shed = shed or service.was_shed(rid)
                ctoks += len(toks)
                toks, finish = self._finish(toks, eos_id, max_new)
                out = tokenizer.decode(toks)
                cut = _first_stop_hit(out, stops)
                if cut is not None:
                    out, finish = out[:cut], "stop"
                    # ids/logprobs must not include tokens past the stop cut
                    toks = _cut_token_ids(tokenizer, toks, cut)
                if lps is not None:
                    lps = lps[: len(toks)]
                if echo:
                    out = (text if text is not None else tokenizer.decode(ids)) + out
                ch = {"index": idx, "text": out, "finish_reason": finish,
                      "token_ids": toks}
                if lps is not None:
                    ch["logprobs"] = {"token_logprobs": lps,
                                      "tokens": [tokenizer.decode([t]) for t in toks]}
                choices.append(ch)
            if shed:
                raise QueueTimeout("request timed out in the pending queue")
            return {
                "id": f"cmpl-{subs[0][0]}", "object": "text_completion",
                "created": int(time.time()), "model": model_name,
                "choices": choices,
                "usage": {"prompt_tokens": ptoks, "completion_tokens": ctoks,
                          "total_tokens": ptoks + ctoks},
            }

        def _beam_completions(self, req, prompts, n, k, stops, max_new,
                              eos_id, echo, want_lp):
            """n choices per prompt from a k-beam search (deterministic —
            sampling params are ignored, like FT's beam layers)."""
            if bool(req.get("stream", False)):
                raise ValueError("stream unsupported with beam search")
            alpha = float(req.get("length_penalty", 1.0))
            timeout = float(req.get("timeout", 600))
            subs = []
            ptoks = 0
            try:
                for prm in prompts:
                    ids, text = self._encode_prompt(prm)
                    ptoks += len(ids)
                    rid = service.submit(ids, SamplingParams(), max_new, eos_id,
                                         beam_width=k, n_best=n,
                                         length_penalty=alpha, logprobs=want_lp)
                    subs.append((rid, ids, text))
            except QueueFull:
                self._rollback([rid for rid, _, _ in subs])
                raise
            choices, ctoks, idx = [], 0, 0
            shed = False
            for rid, ids, text in subs:
                _, nbest = service.wait_nbest(rid, timeout)
                if service.was_shed(rid) or nbest is None:
                    shed = True
                    continue
                for toks, score, lps in nbest[:n]:
                    ctoks += len(toks)
                    toks, finish = self._finish(toks, eos_id, max_new)
                    out = tokenizer.decode(toks)
                    cut = _first_stop_hit(out, stops)
                    if cut is not None:
                        out, finish = out[:cut], "stop"
                        toks = _cut_token_ids(tokenizer, toks, cut)
                    if lps is not None:
                        lps = lps[: len(toks)]
                    if echo:
                        out = (
                            text if text is not None else tokenizer.decode(ids)
                        ) + out
                    ch = {
                        "index": idx, "text": out, "finish_reason": finish,
                        "token_ids": toks, "beam_score": score,
                    }
                    if lps is not None:
                        ch["logprobs"] = {
                            "token_logprobs": lps,
                            "tokens": [tokenizer.decode([t]) for t in toks],
                        }
                    choices.append(ch)
                    idx += 1
            if shed:
                raise QueueTimeout("request timed out in the pending queue")
            return {
                "id": f"cmpl-{subs[0][0]}", "object": "text_completion",
                "created": int(time.time()), "model": model_name,
                "choices": choices,
                "usage": {"prompt_tokens": ptoks, "completion_tokens": ctoks,
                          "total_tokens": ptoks + ctoks},
            }

        def _openai_chat(self, req):
            sampling, stops, max_new, eos_id = self._openai_common(req)
            messages = req["messages"]
            if not isinstance(messages, list) or not messages:
                raise ValueError("messages must be a non-empty list")
            prompt_text = tokenizer.apply_chat_template(messages)
            ids = tokenizer.encode(prompt_text)
            if bool(req.get("stream", False)):
                self._stream(ids, sampling, stops, max_new, eos_id,
                             mode="chat.completion.chunk")
                return None
            rid = service.submit(ids, sampling, max_new, eos_id)
            toks, _ = service.wait_full(rid, float(req.get("timeout", 600)))
            if service.was_shed(rid):
                raise QueueTimeout("request timed out in the pending queue")
            ngen = len(toks)
            toks, finish = self._finish(toks, eos_id, max_new)
            out = tokenizer.decode(toks)
            cut = _first_stop_hit(out, stops)
            if cut is not None:
                out, finish = out[:cut], "stop"
            return {
                "id": f"chatcmpl-{rid}", "object": "chat.completion",
                "created": int(time.time()), "model": model_name,
                "choices": [{
                    "index": 0,
                    "message": {"role": "assistant", "content": out},
                    "finish_reason": finish,
                }],
                "usage": {"prompt_tokens": len(ids), "completion_tokens": ngen,
                          "total_tokens": len(ids) + ngen},
            }

        def _stream(self, ids, sampling, stops, max_new, eos_id, mode):
            """Server-sent events: one chunk per newly decoded text delta."""
            rid = service.submit(ids, sampling, max_new, eos_id)
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            chat = mode == "chat.completion.chunk"
            rid_tag = f"chatcmpl-{rid}" if chat else f"cmpl-{rid}"

            def emit(delta, finish, token_ids=None):
                if chat:
                    d = {"role": "assistant", "content": delta} if delta else {}
                    choice = {"index": 0, "delta": d, "finish_reason": finish}
                else:
                    choice = {"index": 0, "text": delta, "finish_reason": finish}
                if token_ids:
                    # id-level streaming: raw-token clients (and tokenizers
                    # that cannot render an id as text yet) still see every
                    # new token the tick produced
                    choice["token_ids"] = token_ids
                chunk = {"id": rid_tag, "object": mode,
                         "created": int(time.time()), "model": model_name,
                         "choices": [choice]}
                self.wfile.write(b"data: " + json.dumps(chunk).encode() + b"\n\n")
                self.wfile.flush()

            sent_text, finish = "", None
            sent_toks = 0
            deadline = time.monotonic() + 600
            try:
                while finish is None and time.monotonic() < deadline:
                    toks, done = service.peek(rid)
                    if done and service.was_shed(rid):
                        finish = "queue_timeout"
                        break
                    clean, fin = self._finish(toks, eos_id, max_new)
                    text = tokenizer.decode(clean)
                    cut = _first_stop_hit(text, stops)
                    if cut is not None:
                        text, finish = text[:cut], "stop"
                        clean = _cut_token_ids(tokenizer, clean, cut)
                        service.cancel(rid)
                    elif done:
                        finish = fin
                    if finish is None:
                        # hold back an incomplete UTF-8 tail and any suffix
                        # that may still complete a stop string — emitting
                        # them early would corrupt text ('�' for a split
                        # multi-byte char) or leak past the stop cut
                        text = text[: _stream_safe_len(text, stops)]
                    # id stream honors the same stop holdback as text:
                    # ids whose text might still complete a stop string
                    # are withheld until disambiguated (with no stops every
                    # new token streams immediately)
                    safe_clean = (
                        clean if not stops or finish is not None
                        else _cut_token_ids(tokenizer, clean, len(text))
                    )
                    new_toks = (
                        safe_clean[sent_toks:]
                        if len(safe_clean) > sent_toks else []
                    )
                    if len(text) > len(sent_text) or new_toks:
                        emit(text[len(sent_text):], None, token_ids=new_toks)
                        sent_text = text
                        sent_toks = len(safe_clean)
                    if finish is None:
                        time.sleep(0.005)
                emit("", finish or "length")
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
            except OSError:
                pass  # client disconnected mid-stream
            finally:
                # stop decoding for a vanished client and drain the result so
                # the service's _results/_events entries don't leak
                service.cancel(rid)
                try:
                    service.wait_full(rid, timeout=600)
                except (TimeoutError, KeyError):
                    pass

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, TypeError, AssertionError) as e:
                self._send(400, {"error": str(e)})
                return
            if self.path == "/v1/completions":
                try:
                    resp = self._openai_completions(req)
                    if resp is not None:
                        self._send(200, resp)
                except QueueFull as e:
                    self._send_429(e)
                except QueueTimeout as e:
                    self._send_503(e)
                except (KeyError, ValueError, TypeError, AssertionError) as e:
                    self._send(400, {"error": {"message": str(e),
                                               "type": "invalid_request_error"}})
                except TimeoutError as e:
                    self._send(504, {"error": {"message": str(e)}})
                return
            if self.path == "/v1/chat/completions":
                try:
                    resp = self._openai_chat(req)
                    if resp is not None:
                        self._send(200, resp)
                except QueueFull as e:
                    self._send_429(e)
                except QueueTimeout as e:
                    self._send_503(e)
                except (KeyError, ValueError, TypeError, AssertionError) as e:
                    self._send(400, {"error": {"message": str(e),
                                               "type": "invalid_request_error"}})
                except TimeoutError as e:
                    self._send(504, {"error": {"message": str(e)}})
                return
            if self.path != "/generate":
                self._send(404, {"error": "not found"})
                return
            try:
                prompt = [int(t) for t in req["prompt_ids"]]
                sampling = SamplingParams(
                    temperature=float(req.get("temperature", 1.0)),
                    top_k=int(req.get("top_k", 0)),
                    top_p=float(req.get("top_p", 1.0)),
                    repetition_penalty=float(req.get("repetition_penalty", 1.0)),
                    greedy=bool(req.get("greedy", True)),
                )
                want_lp = bool(req.get("logprobs", False))
                bw = int(req.get("beam_width", 1))
                if bw > 1:
                    rid = service.submit(
                        prompt, SamplingParams(),
                        int(req.get("max_new_tokens", 64)),
                        int(req.get("eos_id", 2)),
                        beam_width=bw, n_best=int(req.get("n_best", 1)),
                        length_penalty=float(req.get("length_penalty", 1.0)),
                    )
                    toks, nbest = service.wait_nbest(
                        rid, timeout=float(req.get("timeout", 600))
                    )
                    if service.was_shed(rid) or nbest is None:
                        raise QueueTimeout(
                            "request timed out in the pending queue"
                        )
                    self._send(200, {
                        "request_id": rid, "tokens": toks,
                        "nbest": [
                            {"tokens": t, "score": s}
                            for t, s, _ in nbest
                        ],
                    })
                    return
                rid = service.submit(
                    prompt,
                    sampling,
                    int(req.get("max_new_tokens", 64)),
                    int(req.get("eos_id", 2)),
                    logprobs=want_lp,
                )
                tokens, lps = service.wait_full(
                    rid, timeout=float(req.get("timeout", 600))
                )
                if service.was_shed(rid):
                    raise QueueTimeout("request timed out in the pending queue")
                resp = {"request_id": rid, "tokens": tokens}
                if lps is not None:
                    resp["logprobs"] = lps
                    resp["cum_logprob"] = sum(lps)
                self._send(200, resp)
            except QueueFull as e:
                self._send_429(e)
            except QueueTimeout as e:
                self._send_503(e)
            except (KeyError, ValueError, TypeError, AssertionError) as e:
                self._send(400, {"error": str(e)})
            except TimeoutError as e:
                self._send(504, {"error": str(e)})

    return Handler


def serve_background(scheduler, host: str = "127.0.0.1", port: int = 0,
                     tokenizer=None, model_name: str = "flexq-tpu",
                     max_pending: Optional[int] = None,
                     queue_timeout_s: Optional[float] = None):
    """Start the HTTP server on a daemon thread.
    Returns (server, service, actual_port)."""
    service = SchedulerService(scheduler, max_pending=max_pending,
                               queue_timeout_s=queue_timeout_s)
    server = ThreadingHTTPServer(
        (host, port), _make_handler(service, tokenizer, model_name)
    )
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server, service, server.server_address[1]


def _share_port(port: Optional[int] = None) -> int:
    """Rank 0's replication port, told to every rank through the
    rendezvous (rank 0 passes it, the others receive it)."""
    import torch.distributed as dist

    box = [port]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def main(argv=None):
    import argparse

    import torch

    from flexq_tpu_torch.export.exporter import load_packed, load_packed_sharded, read_meta
    from flexq_tpu_torch.serve.scheduler import BatchScheduler
    from flexq_tpu_torch.serve.tokenizer import load_tokenizer

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint", required=True, help="packed checkpoint dir")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-seq-len", type=int, default=2048)
    ap.add_argument("--kv-dtype", default="bfloat16", choices=["bfloat16", "int8"])
    ap.add_argument("--paged", action="store_true", help="paged KV pool")
    ap.add_argument("--page-size", type=int, default=128)
    ap.add_argument("--prefill-chunk", type=int, default=None)
    ap.add_argument("--prefix-cache", action="store_true",
                    help="reuse identical prompt-prefix pages across requests (paged only)")
    ap.add_argument("--fused-tick", type=int, default=8,
                    help="decode steps fused into one tick (a captured CUDA graph of the step, replayed) when "
                         "every active slot is decoding with the same sampling params; 0 = per-token ticks. "
                         "Bounds queued-request latency to fused_tick steps")
    ap.add_argument("--tokenizer", default=None,
                    help="local HF tokenizer dir for the /v1 text endpoints (default: byte-level fallback)")
    ap.add_argument("--model-name", default="flexq-tpu", help="model id reported by the /v1 endpoints")
    ap.add_argument("--max-pending", type=int, default=256,
                    help="admission bound: submits past this many queued requests get 429 + Retry-After "
                         "(0 = unbounded)")
    ap.add_argument("--queue-timeout", type=float, default=None,
                    help="shed queued requests not admitted within this many seconds (503; default: never)")
    # tensor / data parallel serving: one process per rank (the reference's
    # mpirun ranks); rank 0 serves HTTP and replicates the scheduler's
    # command log to the others (serve/replicated.py)
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel ways (one process per rank)")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel ways (--paged: one pool partition a data rank; --prefix-cache takes dp = 1)")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline-parallel stages (one process per stage; exclusive with --tp / --dp; a dense "
                         "cache and per-token ticks)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0's torch.distributed rendezvous (or a file:// store); over several "
                         "nodes, set LOCAL_WORLD_SIZE to the ranks of each node")
    ap.add_argument("--num-processes", type=int, default=None, help="ranks in all (default tp * dp)")
    ap.add_argument("--process-id", type=int, default=None, help="this process's rank")
    ap.add_argument("--replication-port", type=int, default=8476,
                    help="rank 0's port for the scheduler command-log stream (0: a free one; the other ranks "
                         "learn it through the rendezvous)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="collectives: nccl on the card (a card a rank, the default), gloo on the CPU or for "
                         "ranks that share a card")
    ap.add_argument("--device", default="cuda", help="the card (cuda), or cpu for the plain versions")
    args = ap.parse_args(argv)
    # refused before anything loads
    if args.fused_tick < 0:
        ap.error(f"--fused-tick {args.fused_tick}: must be >= 0")
    if args.pp > 1:
        if args.tp * args.dp > 1:
            ap.error("--pp is exclusive with --tp / --dp")
        if args.paged or args.prefix_cache:
            ap.error("--pp serves a dense cache (no --paged / --prefix-cache), as the reference's")
        args.fused_tick = 0  # the pipeline's ticks are per token, as the reference's
    ranks = args.tp * args.dp * args.pp
    world = args.num_processes or ranks
    if world != ranks:
        ap.error(f"--num-processes {world} != --tp {args.tp} x --dp {args.dp} x --pp {args.pp}")
    if world > 1 and (args.coordinator is None or args.process_id is None):
        ap.error("--tp / --dp / --pp > 1: one process per rank, each given --coordinator and --process-id")
    tp_ckpt = read_meta(args.checkpoint).get("tensor_parallel", 1)
    if tp_ckpt not in (1, args.tp):
        ap.error(f"the checkpoint is tp={tp_ckpt}-sharded: serve it with --tp {tp_ckpt}")

    mesh = pp_mesh = None
    device = args.device
    if args.coordinator is not None:
        from flexq_tpu_torch.parallel.distributed import initialize, process_mesh
        from flexq_tpu_torch.parallel.pp import make_pipe_mesh

        initialize(args.coordinator, world, args.process_id or 0, backend=args.backend, device=args.device)
        if args.pp > 1:
            pp_mesh = make_pipe_mesh(args.pp)
            device = pp_mesh.device
        else:
            mesh = process_mesh(args.tp, args.dp)
            device = mesh.device
    if mesh is not None and tp_ckpt > 1:  # each rank reads its rank files only
        cfg, policy, params = load_packed_sharded(args.checkpoint, mesh)
    else:  # a stage reads the whole tree on the host and keeps its layers
        cfg, policy, params = load_packed(args.checkpoint, device="cpu" if pp_mesh is not None else device)
    sched = BatchScheduler(
        params,
        cfg,
        policy,
        num_slots=args.slots,
        max_seq_len=args.max_seq_len,
        kv_dtype=torch.int8 if args.kv_dtype == "int8" else torch.bfloat16,
        paged=args.paged or args.prefix_cache,
        page_size=args.page_size,
        prefill_chunk=args.prefill_chunk,
        prefix_cache=args.prefix_cache,
        fused_tick=args.fused_tick,
        mesh=mesh,
        pp_mesh=pp_mesh,
        device=device,
    )
    rank_mesh = mesh or pp_mesh
    if rank_mesh is not None and world > 1:
        from flexq_tpu_torch.parallel.distributed import shutdown as leave
        from flexq_tpu_torch.serve.replicated import ReplicatedScheduler

        if rank_mesh.rank > 0:  # rank 0's host: the rendezvous's, or this machine's for a file:// store
            host = "127.0.0.1" if args.coordinator.startswith("file://") else \
                args.coordinator.split("://")[-1].rsplit(":", 1)[0]
            port = _share_port()
            print(f"rank {rank_mesh.rank} following {host}:{port}", flush=True)
            ReplicatedScheduler(sched, leader=False, leader_addr=(host, port)).serve_forever()
            leave()
            return
        sched = ReplicatedScheduler(sched, leader=True, port=args.replication_port, num_followers=world - 1,
                                    announce=_share_port)
    server, service, port = serve_background(
        sched, args.host, args.port,
        tokenizer=load_tokenizer(args.tokenizer), model_name=args.model_name,
        max_pending=args.max_pending or None,
        queue_timeout_s=args.queue_timeout,
    )
    print(f"serving on {args.host}:{port} ({args.slots} slots)", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        service.shutdown()
        server.shutdown()
        if rank_mesh is not None and world > 1:
            sched.shutdown()  # the followers return from serve_forever
            leave()


if __name__ == "__main__":
    main()
