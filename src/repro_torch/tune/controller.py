"""Adaptive flush control: close the loop between arrival rate and the
cost of serving a batch (counterpart of ``repro/tune/controller.py``).

A static ``FlushPolicy.max_delay_s`` is wrong at both ends: at high
arrival rates it waits long after an efficient batch has accumulated; at
low rates it parks a lone caller for the full deadline even though the
card could serve it in microseconds.  The paper's Observation 2 frames
the underlying tradeoff -- small-batch surrogate calls waste the
hardware -- so the controller picks, per serving key:

  * a **bucket target** B*: the smallest power-of-two batch whose
    per-row latency is within ``amortize_eps`` of the large-batch
    asymptote (past B*, fatter batches barely help);
  * a **deadline**: the time the observed arrival rate needs to
    accumulate B* rows, capped at ``service_factor`` x the service time
    of B* (waiting much longer than a batch costs to serve buys
    nothing) and clamped to ``[min_delay_s, max_delay_s]``.

The batch-latency model is **closed-loop**: once ``ServeStats`` has
recorded ``measured_min_batches`` dispatches of a bucket, that bucket's
measured EWMA wall time supersedes the roofline prediction (measured
wins once warm); buckets not yet observed use the roofline prediction
scaled by the correction factor of the nearest *measured* bucket -- one
warm bucket recalibrates the whole curve.  The measured model feeds two
decisions differently:

  * the **bucket target** uses it symmetrically -- it is a shape
    question (where does batching stop paying?) and the measured curve
    answers it better in both directions;
  * the **deadline cap** uses it to *tighten only*: the prior cap
    (``service_factor`` x roofline) is the policy's bound on worthwhile
    waiting, and a measured service time below it proves even that wait
    was pointless, so the cap shrinks to ``measured_service_factor`` x
    measured.  A measured time *above* the prior must never inflate the
    deadline -- holding callers longer because serving got slower would
    compound a slowdown into queueing delay.

``use_measured=False`` is the open-loop controller (roofline only).

Degradation stays graceful and layered: the roofline term needs only
the net's widths, so it applies from the very first request; the
arrival rate needs warm stats, so the fill term stays out of the
decision until ``warmup_requests`` submits have been observed; measured
latencies need completed batches, so the roofline remains the cold-start
prior.  A key whose widths cannot be derived from its bundle (not a
pure MLP, missing spec) falls all the way back to the static policy
values, so a queue with a controller can never behave worse than its
``FlushPolicy``.

What the port does differently: the roofline prior is priced at the
H100's peaks (:mod:`repro_torch.dist.hlo_analysis`: the 3xTF32 rate
``fused_mlp`` computes at, HBM3 bandwidth) with the fused-MLP resource
counts (weights stream once per batch, the intermediate activations
stay in shared memory and registers), plus a dispatch floor measured on
the card (:data:`DISPATCH_FLOOR_S`), where the reference prices at a
TPU's peaks plus a guessed 150 us.  With the same explicit constants
both controllers make the same decisions (``tests/test_torch_controller.
py``).
"""
from __future__ import annotations

import json
import math
import pathlib
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from repro_torch.dist.hlo_analysis import HBM_BW, PEAK_FLOPS, Roofline
from repro_torch.obs import metrics as _m

#: Dispatch floor: the median host time of a warm
#: ``InferenceEngine.apply_batched`` of 8 card-resident rows of the
#: full-width f32 minibude bundle, each call ended by
#: ``torch.cuda.synchronize()``, over 200 calls from one thread
#: (``chip_smoke.py``'s ``control_slice`` phase, part ``floor``; the
#: int8 bundle's was 380.5e-6).  Measured on
#: "NVIDIA H100 80GB HBM3, 700.00 W".
DISPATCH_FLOOR_S = 738.8e-6

_DECISIONS = _m.counter(
    "repro_controller_decisions_total",
    "adaptive flush decisions by latency-model source",
    ("key", "source"))


def mlp_resources(widths, batch: int, dtype_bytes: int = 4,
                  weight_dtype_bytes: Optional[int] = None):
    """(flops, hbm_bytes) for one fused-MLP batch of ``batch`` rows.

    ``weight_dtype_bytes`` prices the weight stream at its own width
    when it differs from the activation dtype — the int8 tier quarters
    the weight bytes (1 vs 4) while activations stay f32.  The scale
    vectors the quantized layers add (one f32 per output channel) ride
    along in the bias term, which already counts one f32 per output
    channel; the model keeps them at f32 whatever the weights are.
    """
    if weight_dtype_bytes is None:
        weight_dtype_bytes = dtype_bytes
    wsum = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    flops = batch * (2.0 * wsum + sum(widths[1:]))  # dots + bias adds
    weight_bytes = (wsum * weight_dtype_bytes
                    + sum(widths[1:]) * dtype_bytes)  # + biases/scales
    io_bytes = batch * (widths[0] + widths[-1]) * dtype_bytes
    return flops, weight_bytes + io_bytes


def predict_batch_latency_s(widths, batch: int, *, chips: int = 1,
                            dtype_bytes: int = 4,
                            weight_dtype_bytes: Optional[int] = None,
                            overhead_s: float = DISPATCH_FLOOR_S,
                            peak_flops: float = PEAK_FLOPS,
                            hbm_bw: float = HBM_BW) -> float:
    """Roofline-predicted wall time to serve one batch of ``batch`` rows."""
    flops, hbm = mlp_resources(widths, batch, dtype_bytes,
                               weight_dtype_bytes)
    roof = Roofline(flops_global=flops, hbm_bytes_global=hbm,
                    coll_bytes_global=0.0, chips=chips, model_flops=flops,
                    peak_flops=peak_flops, hbm_bw=hbm_bw)
    return roof.step_time_s + overhead_s


def _default_widths_for(key: str):
    """Derive fused-MLP widths from a bundle path (the serve-queue key)."""
    from repro_torch.tune.kernel_tuner import widths_from_spec
    spec = json.loads((pathlib.Path(key) / "spec.json").read_text())
    return widths_from_spec(spec)


class AdaptiveFlushController:
    """Per-key closed-loop (deadline, bucket-target) policy.

    Plug into a queue with ``ServeQueue(policy, controller=ctrl)``; the
    queue consults :meth:`delay_for` wherever it used the static
    ``policy.max_delay_s`` and :meth:`batch_rows_for` for the max-batch
    trigger.  Both run under the queue lock, so they are kept cheap:
    widths resolve once per key ever (spec.json is read on first touch
    and the result — including failure — is cached), and full delay /
    bucket-target decisions are memoized for ``decision_ttl_s`` so a
    dispatcher that wakes every few hundred microseconds re-prices a
    key at most once per TTL window (the TTL is also what lets fresh
    measured latencies flow back into the decision).
    """

    def __init__(self, policy=None, *,
                 widths_for: Optional[Callable] = None,
                 chips: int = 1,
                 min_delay_s: float = 2e-4,
                 max_delay_s: float = 0.05,
                 warmup_requests: int = 8,
                 service_factor: float = 4.0,
                 measured_service_factor: float = 1.5,
                 amortize_eps: float = 0.1,
                 overhead_s: float = DISPATCH_FLOOR_S,
                 decision_ttl_s: float = 0.01,
                 use_measured: bool = True,
                 measured_min_batches: int = 2,
                 correction_clamp: float = 20.0,
                 peak_flops: float = PEAK_FLOPS,
                 hbm_bw: float = HBM_BW,
                 tenancy=None):
        if policy is None:
            from repro_torch.serve.queue import FlushPolicy
            policy = FlushPolicy()
        self.policy = policy
        self.chips = chips
        self.min_delay_s = min_delay_s
        self.max_delay_s = max_delay_s
        self.warmup_requests = warmup_requests
        self.service_factor = service_factor
        self.measured_service_factor = measured_service_factor
        self.amortize_eps = amortize_eps
        self.overhead_s = overhead_s
        self.decision_ttl_s = decision_ttl_s
        self.use_measured = use_measured
        self.measured_min_batches = measured_min_batches
        self.correction_clamp = correction_clamp
        self.peak_flops = peak_flops
        self.hbm_bw = hbm_bw
        # tenancy board (repro_torch.serve.tenancy.TenantBoard): a key bound
        # to a QoS tier gets that tier's deadline target as a per-key
        # bound — latency tenants cap the wait, throughput tenants may
        # wait past the static policy to build fat batches.  ServeQueue
        # wires this automatically when both are attached.
        self.tenancy = tenancy
        self._widths_for = widths_for or _default_widths_for
        self._lock = threading.Lock()
        self._widths: Dict[str, Optional[list]] = {}
        self._memo: Dict[str, Tuple[float, Optional[float]]] = {}
        self._target_memo: Dict[str, Tuple[float, int]] = {}
        self.last_decision: Dict[str, dict] = {}  # observability, per key

    # ------------------------------------------------------------ model ---
    def _widths_cached(self, key: str):
        with self._lock:
            if key in self._widths:
                return self._widths[key]
        try:
            w = self._widths_for(key)
        except Exception as exc:
            w = None  # unknown bundle shape -> degrade to static policy
            _m.note_static_fallback(key, "unknown-widths", repr(exc))
        with self._lock:
            self._widths[key] = w
        return w

    def predict_latency_s(self, widths, batch: int) -> float:
        """Open-loop roofline prior (no observations consulted)."""
        return predict_batch_latency_s(
            widths, batch, chips=self.chips, overhead_s=self.overhead_s,
            peak_flops=self.peak_flops, hbm_bw=self.hbm_bw)

    def latency_s(self, widths, batch: int, stats,
                  pred: Optional[float] = None) -> Tuple[float, str]:
        """Closed-loop batch latency: (seconds, source).

        Source is ``"measured"`` when the exact bucket is warm in
        ``stats``, ``"corrected"`` when another bucket's measured /
        predicted ratio recalibrates the roofline, ``"roofline"`` when
        stats are cold (or ``use_measured`` is off).  Any stats access
        failure degrades to the roofline prior — the controller must
        never raise into the queue.  Callers that already evaluated the
        roofline for ``batch`` pass it as ``pred`` (these run under the
        queue lock, so redundant model evaluations are real cost).
        """
        if pred is None:
            pred = self.predict_latency_s(widths, batch)
        if not self.use_measured or stats is None:
            return pred, "roofline"
        try:
            meas = stats.batch_latency_s(batch, self.measured_min_batches)
            if meas is not None and meas > 0.0:
                return meas, "measured"
            warm = [(b, e) for b, (e, n) in stats.batch_latencies().items()
                    if n >= self.measured_min_batches and e > 0.0 and b > 0]
        except Exception:
            return pred, "roofline"
        if not warm:
            return pred, "roofline"
        # nearest warm bucket (log-scale) recalibrates the prediction:
        # the roofline's shape is right, its constants may not be
        b0, e0 = min(warm, key=lambda be: abs(math.log(be[0] / max(batch, 1))))
        corr = e0 / max(self.predict_latency_s(widths, b0), 1e-12)
        corr = min(max(corr, 1.0 / self.correction_clamp),
                   self.correction_clamp)
        return pred * corr, "corrected"

    def _bucket_target(self, key: str, widths, stats) -> int:
        """Smallest power-of-two bucket within amortize_eps of the
        asymptotic per-row latency — past it, bigger batches mostly add
        queueing delay, not throughput.  Re-derived per TTL window so
        measured latencies reshape the curve as they warm."""
        now = time.monotonic()
        with self._lock:
            memo = self._target_memo.get(key)
            if memo is not None and now - memo[0] < self.decision_ttl_s:
                return memo[1]
        from repro_torch.serve.batcher import bucket_size
        lo = bucket_size(1, self.policy.min_bucket)
        hi = bucket_size(self.policy.max_batch_rows, self.policy.min_bucket)
        asymptote = self.latency_s(widths, hi, stats)[0] / hi
        target = hi
        b = lo
        while b <= hi:
            if self.latency_s(widths, b, stats)[0] / b <= \
                    (1.0 + self.amortize_eps) * asymptote:
                target = b
                break
            b *= 2
        with self._lock:
            self._target_memo[key] = (now, target)
        return target

    # ---------------------------------------------------- queue contract ---
    def delay_for(self, key: str, stats) -> Optional[float]:
        """Deadline for ``key``'s oldest pending request.

        Two terms, different information sources:

          * the **service cap** (``service_factor`` x batch latency)
            comes from the closed-loop latency model — roofline-only
            from the first request, measured once batches have
            completed;
          * the **fill time** (bucket target / arrival rate) needs warm
            stats; until ``warmup_requests`` submits it is infinite and
            the cap governs.

        Only a key whose widths cannot be derived (non-MLP bundle,
        missing spec) degrades all the way to the static policy value.
        """
        now = time.monotonic()
        memo = self._memo.get(key)
        if memo is not None and now - memo[0] < self.decision_ttl_s:
            return memo[1]
        static = self.policy.max_delay_s
        widths = self._widths_cached(key)
        if not widths:
            self._memo[key] = (now, static)
            return static
        target = self._bucket_target(key, widths, stats)
        # the service cap prices the batch *already pending* (waiting
        # longer than it costs to serve what is queued buys nothing —
        # more rows may never come), not the aspirational target bucket
        from repro_torch.serve.batcher import bucket_size
        pending = max(int(getattr(stats, "queue_depth_rows", 0) or 0), 1)
        cap_bucket = bucket_size(pending, self.policy.min_bucket)
        if self.use_measured and stats is not None:
            # the batcher's dispatch buckets are shard-rounded
            # (bucket_for), not always powers of two — prefer the
            # smallest bucket actually *observed* covering the pending
            # rows, or the exact-measured lookup below never hits on a
            # non-pow2 shard count
            try:
                observed = [b for b, (_, n) in stats.batch_latencies()
                            .items()
                            if n >= self.measured_min_batches
                            and b >= pending]
                if observed:
                    cap_bucket = min(cap_bucket, min(observed))
            except Exception:
                pass
        pred = self.predict_latency_s(widths, cap_bucket)
        t_serve, source = self.latency_s(widths, cap_bucket, stats, pred)
        rate = 0.0
        if stats is not None and \
                stats.requests_enqueued >= self.warmup_requests:
            rate = stats.arrival_rate_rows_s()
        fill_s = target / rate if rate > 0.0 else float("inf")
        # Measured latency TIGHTENS the cap, never loosens it.  The
        # prior cap (service_factor x roofline) is the policy's bound on
        # worthwhile waiting; a measured service time *below* it proves
        # even that wait was pointless, so the bound shrinks (with the
        # tight measured factor — the x4 pad covered model uncertainty
        # that no longer exists).  A measured time *above* it must not
        # inflate the deadline: holding callers longer because serving
        # got slower turns a slowdown into compounding queueing delay —
        # exactly the feedback loop a latency-biased queue must avoid.
        cap = self.service_factor * pred
        if source != "roofline":
            cap = min(cap, self.measured_service_factor * t_serve)
        delay = min(fill_s, cap)
        hi = static if static is not None else self.max_delay_s
        # QoS tier bound: a latency-tier tenant's target *caps* how long
        # its key may wait (an SLO, not a hint); a throughput-tier
        # target *raises* the ceiling so fat batches can fill even when
        # the static policy is tighter.  Board failures degrade to the
        # tier-free decision — the controller must never raise into the
        # queue.
        tier = target_s = None
        if self.tenancy is not None:
            try:
                tier, target_s = self.tenancy.qos_for_key(key)
            except Exception:
                tier = target_s = None
        if target_s is not None:
            hi = min(hi, target_s) if tier == "latency" \
                else max(hi, target_s)
        delay = max(self.min_delay_s, min(delay, hi))
        self.last_decision[key] = {
            "arrival_rate_rows_s": rate, "bucket_target": target,
            "cap_bucket": cap_bucket,
            "batch_latency_s": t_serve, "latency_source": source,
            "predicted_batch_latency_s": pred,
            "fill_s": fill_s, "delay_s": delay,
            "qos_tier": tier, "qos_target_s": target_s}
        _DECISIONS.inc(1, key=key, source=source)
        self._memo[key] = (now, delay)
        return delay

    def batch_rows_for(self, key: str, stats) -> int:
        """Adaptive max-batch trigger: flush once the efficient bucket
        has accumulated instead of waiting for the static cap.  Model-
        driven from the first request; measured latencies sharpen the
        target as batches complete."""
        cap = self.policy.max_batch_rows
        widths = self._widths_cached(key)
        if not widths:
            return cap
        return min(cap, self._bucket_target(key, widths, stats))
