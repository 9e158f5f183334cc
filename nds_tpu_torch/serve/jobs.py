"""Resumable server-side stream jobs: `POST /stream` + `GET /jobs/<id>`.

A whole generated query stream runs as ONE background job on the warm
service session — the serve-mode analogue of a Power Run, submitted over
HTTP instead of a CLI invocation. Job progress checkpoints to an
atomically-rewritten per-job state file on full_bench's `bench_state` pattern
(fingerprint-guarded: a resubmitted job with the same id + stream resumes
from its completed set instead of re-running finished queries; a state
file from a DIFFERENT stream under the same id is a loud error), so a
server restart — or a drain that paused the job mid-stream — loses at
most the in-flight query.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time

from ..engine.lockdebug import make_lock
from ..io.fs import fs_open_atomic


def resolve_job_dir(conf: dict | None = None) -> str:
    """Job-state directory (`engine.serve_job_dir` / NDS_SERVE_JOB_DIR);
    default under the system temp dir, per-user."""
    v = None
    if conf:
        v = conf.get("engine.serve_job_dir")
    if v is None:
        v = os.environ.get("NDS_SERVE_JOB_DIR")
    if v:
        return str(v)
    import tempfile

    return os.path.join(
        tempfile.gettempdir(), f"nds-tpu-torch-serve-jobs-{os.getuid()}"
    )


class StreamJobs:
    """In-memory registry + on-disk checkpoints of stream jobs."""

    #: per-query shed (429) retry budget + linear backoff base: a job is
    #: background work, so it yields to interactive load and tries again
    SHED_RETRIES = 10
    SHED_BACKOFF_S = 0.5

    def __init__(self, service, job_dir: str | None = None):
        self.service = service
        self.job_dir = job_dir or resolve_job_dir(
            getattr(service.session, "conf", None)
        )
        self._lock = make_lock("StreamJobs._lock")
        # nds-guarded-by: _lock
        self._jobs = {}  # job_id -> state dict, under _lock

    # ------------------------------------------------------------------
    def _state_path(self, job_id: str) -> str:
        return os.path.join(self.job_dir, f"serve-job-{job_id}.json")

    @staticmethod
    def _fingerprint(stream: str, names) -> str:
        blob = json.dumps([str(stream), sorted(names)])
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def submit(self, stream, job_id=None, sub_queries=None,
               tenant="default"):
        """Start (or resume) a job over a server-side stream file.
        Returns the public job snapshot immediately (202 semantics)."""
        from ..power import gen_sql_from_stream, get_query_subset

        if not stream:
            raise ValueError("stream job needs 'stream' (a server-side "
                             "generated stream file path)")
        queries = gen_sql_from_stream(str(stream))
        if sub_queries:
            queries = get_query_subset(queries, list(sub_queries))
        names = list(queries)
        fp = self._fingerprint(stream, names)
        if not job_id:
            job_id = fp
        job_id = str(job_id)
        with self._lock:
            live = self._jobs.get(job_id)
            if live is not None and live["state"] == "running":
                return self._public(live)
            completed = self._completed_from_checkpoint(job_id, fp)
            job = {
                "job_id": job_id,
                "fingerprint": fp,
                "stream": str(stream),
                "tenant": tenant,
                "state": "running",
                "total": len(names),
                "queries": dict(completed),
                "started_ts_ms": int(time.time() * 1000),
            }
            self._jobs[job_id] = job
        t = threading.Thread(
            target=self._run_job, args=(job, queries),
            name=f"nds-serve-job-{job_id}", daemon=True,
        )
        t.start()
        with self._lock:
            return self._public(job)

    def _completed_from_checkpoint(self, job_id, fp):
        """Completed-query records from a prior checkpoint with a
        MATCHING fingerprint (the resume set); a fingerprint mismatch is
        a loud error — resuming a different stream under the same id
        would silently mix two jobs' results."""
        path = self._state_path(job_id)
        if not os.path.exists(path):
            return {}
        try:
            with open(path, encoding="utf-8") as f:
                raw = json.load(f)
        except (OSError, ValueError):
            return {}  # torn/unreadable checkpoint: start fresh
        if raw.get("fingerprint") != fp:
            raise ValueError(
                f"job {job_id!r} checkpoint was written by a different "
                f"stream (fingerprint {raw.get('fingerprint')} != {fp}); "
                f"pick a new job_id or delete {path}"
            )
        return {
            name: rec
            for name, rec in (raw.get("queries") or {}).items()
            if rec.get("status") == "completed"
        }

    def _checkpoint(self, job):
        try:
            os.makedirs(self.job_dir, exist_ok=True)
            with fs_open_atomic(self._state_path(job["job_id"]), "w") as f:
                json.dump(job, f, indent=2, default=str)
        except OSError:
            pass  # checkpointing is resilience, not correctness

    def _run_job(self, job, queries):
        """Sequential stream execution through the service's OWN admission
        path (each query claims a slot like an external request would — a
        job must not starve interactive tenants). A drain pauses the job
        at the next query boundary; resubmission resumes it."""
        svc = self.service
        tenant = job["tenant"]
        for name, sql_text in queries.items():
            if name in job["queries"]:
                continue  # resumed: already completed in a prior run
            t0 = time.perf_counter()
            # a 429 here is BACKPRESSURE (the job competes for admission
            # slots with interactive tenants by design), not a query
            # failure: back off and retry the bounded budget, so a busy
            # minute doesn't brand the whole job 'failed'
            for attempt in range(self.SHED_RETRIES + 1):
                if svc.draining:
                    self._finish(job, state="paused")
                    return
                status, _, body, _ = svc.handle_query(
                    {"sql": sql_text, "limit": 1}, tenant
                )
                if status not in (429, 503):
                    break
                time.sleep(self.SHED_BACKOFF_S * (attempt + 1))
            if status == 503:
                # raced a drain flip mid-request: pause, resumable
                self._finish(job, state="paused")
                return
            rec = {
                "status": "completed" if status == 200 else "failed",
                "http_status": status,
                "ms": round((time.perf_counter() - t0) * 1000.0, 3),
            }
            if status != 200:
                try:
                    rec["error"] = json.loads(body).get("error")
                except ValueError:
                    pass
            # mutations hold the registry lock: GET /jobs iterates this
            # dict via _public while the job runs
            with self._lock:
                job["queries"][name] = rec
            self._checkpoint(job)
        with self._lock:
            failed = sum(
                1 for r in job["queries"].values()
                if r["status"] != "completed"
            )
            job["state"] = "failed" if failed else "completed"
            job["failed"] = failed
        self._checkpoint(job)

    def _finish(self, job, state):
        with self._lock:
            job["state"] = state
        self._checkpoint(job)

    # ------------------------------------------------------------------
    def _public(self, job) -> dict:
        done = sum(
            1 for r in job["queries"].values()
            if r.get("status") == "completed"
        )
        failed = sum(
            1 for r in job["queries"].values()
            if r.get("status") == "failed"
        )
        return {
            "job_id": job["job_id"],
            "state": job["state"],
            "stream": job["stream"],
            "tenant": job["tenant"],
            "total": job["total"],
            "completed": done,
            "failed": failed,
            "queries": dict(job["queries"]),
        }

    def get(self, job_id):
        with self._lock:
            job = self._jobs.get(str(job_id))
            if job is not None:
                # snapshot under the lock: the runner thread mutates
                # job["queries"] while we iterate it
                return self._public(job)
        # not live in this process: fall back to the checkpoint (a
        # restarted server can still report a prior run's progress)
        path = self._state_path(str(job_id))
        try:
            with open(path, encoding="utf-8") as f:
                raw = json.load(f)
        except (OSError, ValueError):
            return None
        return self._public(raw) if raw.get("queries") is not None else None

    def running_count(self) -> int:
        with self._lock:
            return sum(
                1 for j in self._jobs.values() if j["state"] == "running"
            )
