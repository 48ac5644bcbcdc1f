"""One rank of a gang (``experiment/_gang.py``):
``python -m determined_tpu_torch.exec.gang_rank SPEC``.

The launcher sets torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``)
and writes the spec.  The rank opens the process group on its block's
device (``spec["devices"][LOCAL_RANK]``, NCCL on CUDA, gloo on the CPU),
builds the trial from ``module:qualname`` and runs ``train.init`` ->
``Trainer(trial).fit`` on the configuration's mesh.  The chief connects
to the parent's relay: each validation goes up and waits for the
searcher's stop decision, each finalized checkpoint goes up, a
``preempt`` from the parent (or the parent's end of the socket closing)
flags the chief's preemption, which the ranks' vote turns into a
checkpoint and an exit everywhere; at the end the fit summary, the
kernel launch counts and the tracer's events go up, and every rank writes
its checkpoint spans (``checkpoint.*``: its own save, write and finalize
times) to ``rank<r>.spans.json`` beside its log.  SIGTERM and SIGINT flag
the preemption on any rank.  A rank that raises writes the kind of
its error (``utils.errors.classify_failure``) to
``rank<r>.failure.json`` beside its log and exits 1.  The experiment's
manifest check of the resume point (``spec["verdict"]``) spares each rank's
restore its own md5 pass while the files keep their sizes and mtimes.
"""

from __future__ import annotations

import json
import os
import queue
import signal
import socket
import sys
import threading
import traceback
from typing import Any, Dict, Optional


def launch_counts() -> Dict[str, Any]:
    """Every kernel launch counter of this process."""
    import determined_tpu_torch.ops.flash_attention as fa
    from determined_tpu_torch.ops import fused_adamw as fw
    from determined_tpu_torch.train import _quant

    return dict(flash_fwd=fa.launches, flash_bwd_dq=fa.launches_bwd_dq,
                flash_bwd_dkv=fa.launches_bwd_dkv, fused_adamw=fw.launches,
                quantized=dict(_quant.launches))


class _ChiefRelay:
    """The chief's end of the relay: requests wait for their reply; a
    ``preempt`` from the parent, or its end closing, calls ``on_preempt``."""

    def __init__(self, port: int, token: str, on_preempt) -> None:
        from determined_tpu_torch.core._distributed import _recv_msg, _send_msg

        self._send_msg, self._recv_msg = _send_msg, _recv_msg
        self._sock = socket.create_connection(("127.0.0.1", port), timeout=60.0)
        self._sock.settimeout(None)
        self._lock = threading.Lock()
        self._replies: "queue.Queue[Any]" = queue.Queue()
        self._on_preempt = on_preempt
        self.send(("hello", token))
        threading.Thread(target=self._read, name="dtt-gang-relay", daemon=True).start()

    def _read(self) -> None:
        while True:
            try:
                msg = self._recv_msg(self._sock)
            except (OSError, ConnectionError, EOFError):
                # the parent is gone: checkpoint and stop
                self._on_preempt()
                self._replies.put(("stop", False))
                return
            if msg[0] == "preempt":
                self._on_preempt()
            else:
                self._replies.put(msg)

    def send(self, msg: Any) -> None:
        with self._lock:
            self._send_msg(self._sock, msg)

    def request(self, msg: Any) -> Any:
        self.send(msg)
        return self._replies.get()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def run(spec: Dict[str, Any]) -> None:
    import torch

    from determined_tpu_torch import core
    from determined_tpu_torch.config.experiment import ExperimentConfig, Length
    from determined_tpu_torch.core import DistributedContext
    from determined_tpu_torch.experiment._gang import import_trial
    from determined_tpu_torch.observability import get_tracer
    from determined_tpu_torch.train import Callback, Trainer, init as train_init

    holder: Dict[str, Any] = {}

    def preempt() -> None:
        # plain writes: safe from a signal handler and the relay thread
        holder["preempt"] = True
        ctx = holder.get("core")
        if ctx is not None:
            ctx.preempt.simulate()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: preempt())

    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    device = torch.device(spec["devices"][local_rank])
    cfg = ExperimentConfig.parse(spec["config"])
    obs = cfg.observability
    tracer = get_tracer()
    tracer.configure(enabled=obs.enabled, ring_capacity=obs.ring_capacity,
                     flush_interval=obs.flush_interval_s, max_events=obs.max_events)
    if obs.enabled:
        tracer.start()
    dist = DistributedContext.from_torch(device=device)
    relay: Optional[_ChiefRelay] = None
    try:
        core_ctx = core._dummy_init(distributed=dist, checkpoint_dir=spec["checkpoint_dir"],
                                    trace_dir=spec.get("trace_dir"))
        holder["core"] = core_ctx
        verdict = spec.get("verdict")
        if verdict:
            sid, stats = verdict
            core_ctx.checkpoint.accept_verified(sid, {k: tuple(v) for k, v in stats.items()})
        if spec.get("preempt") or holder.get("preempt"):
            # asked for before this rank could take it
            core_ctx.preempt.simulate()
        trial_cls = import_trial(spec["entrypoint"])
        ctx = train_init(hparams=spec["hparams"], core_context=core_ctx, exp_config=cfg,
                         seed=int(spec["seed"]), device=device)
        trial = trial_cls(ctx)
        trainer = Trainer(trial)
        fit = dict(spec["fit"])
        max_length = Length.parse(fit.pop("max_length"))
        if dist.is_chief:
            relay = _ChiefRelay(int(spec["relay_port"]), spec["relay_token"], preempt)
            _hook_chief(relay, core_ctx, trial, trainer, max_length, Callback)
        summary = trainer.fit(max_length, **fit)
        tracer.stop()
        events = tracer.chrome_events()
        with open(os.path.join(spec["attempt_dir"], f"rank{dist.rank}.spans.json"), "w") as f:
            json.dump([e for e in events if e["ph"] == "X"
                       and e["name"].startswith("checkpoint.")], f)
        if relay is not None:
            relay.send(("result", summary, launch_counts(), events, tracer.epoch))
        core_ctx.close()
    finally:
        if relay is not None:
            relay.close()
        dist.close()


def _hook_chief(relay: _ChiefRelay, core_ctx: Any, trial: Any, trainer: Any, max_length: Any,
                callback_base: type) -> None:
    """Send the chief's validations (and take the searcher's answer) and
    its finalized checkpoints up the relay."""
    orig_report = core_ctx.train.report_validation_metrics

    def report_validation(steps: int, metrics: Dict[str, Any]) -> None:
        orig_report(steps, metrics)
        try:
            horizon = trainer._to_batches(max_length) or 1
        except (AttributeError, TypeError, ZeroDivisionError):
            horizon = max(max_length.units, 1)
        _, stop = relay.request(("validation", steps, dict(metrics), trainer.latest_checkpoint,
                                 min(steps / horizon, 1.0)))
        if stop:
            core_ctx.preempt.simulate()

    core_ctx.train.report_validation_metrics = report_validation

    class _RelayCheckpoints(callback_base):
        def on_checkpoint_write_end(self, storage_id: str) -> None:
            relay.send(("checkpoint", storage_id))

    build = trial.build_callbacks

    def build_callbacks() -> Dict[str, Any]:
        return dict(build(), _gang_relay=_RelayCheckpoints())

    trial.build_callbacks = build_callbacks


def main(argv: Optional[list] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    with open(argv[0]) as f:
        spec = json.load(f)
    try:
        run(spec)
    except BaseException as e:  # noqa: BLE001 - recorded for the launcher, then exit 1
        from determined_tpu_torch.utils.errors import classify_failure

        traceback.print_exc()
        rank = os.environ.get("RANK", "0")
        path = os.path.join(spec["attempt_dir"], f"rank{rank}.failure.json")
        with open(path, "w") as f:
            json.dump({"kind": classify_failure(e).value, "error": repr(e)}, f)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
