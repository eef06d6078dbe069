"""Host-side SCOPE scheduler: firing decisions mirrored on the host.

The decode gates and counters (``current_decoding_step`` / ``jump_step`` /
``jump_layer`` and the ``k_len >= P + W(t)`` checks) depend only on step
counts and cache lengths, both fixed by the prompt length.  Nothing about
WHEN compression fires depends on data; only WHAT is kept (the top-k)
does.  So the host mirrors the counters exactly and dispatches per step
either a hot step with no compression logic (``compress_mode="off"``) or a
force step with an unconditional rewrite (``compress_mode="force"``): the
device is never asked whether to fire, and the hot step needs no host
sync.

A copy of the JAX package's ``compression/host_sched.py`` for the
layer-uniform methods (:class:`HostScheduler`), without its lazy-eviction
mirror (the physical fill pointer and the compaction schedule), which the
port does not need (ROADMAP §1 item 11).  The per-layer mirrors of
pyramidkv and quest (``LayeredHostScheduler``, ``QuestHostScheduler``,
``pyramid_prefill_kept``) come with those methods (ROADMAP §1 item 13).
"""

from __future__ import annotations

from dataclasses import dataclass

from scope_tpu_torch.config import CompressionConfig


def host_schedulable(comp: CompressionConfig) -> bool:
    """Methods whose decode gates the host can mirror exactly with one
    length stream (fullkv/allkv/h2o/snapkv/streamingllm; quest mirrors
    per-layer lengths)."""
    if comp.mistral_window_parity:
        # The per-step positional window slicing mutates lengths in a way
        # the host mirror does not model.
        return False
    if comp.method in ("fullkv", "allkv", "h2o", "snapkv",
                       "streamingllm", "quest") \
            and comp.decoding_metric in ("none", "fixed", "linear", "jump"):
        return True
    # Method-specific metrics: their gates are pure length thresholds, so
    # the host mirrors them like `fixed`; the rewrite re-ranks from slot 0.
    return (comp.method, comp.decoding_metric) in (
        ("h2o", "h2o"), ("streamingllm", "slm"))


def host_schedulable_layered(comp: CompressionConfig) -> bool:
    """PyramidKV: per-layer prefill budgets make lengths (and fire steps)
    differ per layer, still deterministic — a per-layer mirror."""
    return (comp.method == "pyramidkv"
            and not comp.mistral_window_parity
            and comp.decoding_metric in ("none", "fixed", "linear",
                                         "jump", "pyramidinfer"))


@dataclass
class StepPlan:
    fire: bool
    n_keep: int = 0          # tokens kept from the scored region
    w_t: int = 0             # current decode window budget


class HostScheduler:
    """Python mirror of the reference per-layer-call counters.

    One instance per request stream.  Counters advance exactly as the
    device scheduler's do (one increment per layer call); ``length``
    mirrors the device cache length."""

    def __init__(self, comp: CompressionConfig, num_layers: int,
                 prompt_len: int, prefill_kept: int, keep_cap: int,
                 capacity: int = 0):
        self.comp = comp
        self.L = num_layers
        self.metric = comp.decoding_metric
        # pseg: the scheduling boundary.
        if comp.method in ("allkv", "fullkv"):
            self.pseg = prompt_len
        else:
            self.pseg = comp.max_capacity_prompt
        self.length = prefill_kept        # the cache length (gates)
        self.capacity = capacity
        self.keep_cap = keep_cap
        self.step_counter = 0             # current_decoding_step
        self.jump_step = 0
        self.jump_layer = 0

    def plan_step(self) -> StepPlan:
        """Advance one decode step (all L layer calls) and return whether
        this step's layers fire.  The gates see the appended length."""
        comp = self.comp
        self.length += 1                  # the appended token
        m = self.metric
        if m == "none" or comp.method == "fullkv":
            return StepPlan(fire=False)
        W = comp.decoding_window_size
        r = comp.decoding_recent_size
        thresh = comp.delta * self.L

        if m in ("h2o", "slm"):
            # Method-specific global metrics: gate on pseg+W like fixed,
            # but the rewrite re-ranks the WHOLE cache from slot 0 (device
            # pseg=0) keeping pseg+W-r (top-scored for h2o, positional for
            # slm) + the recent r.  Mirrors schedulers.schedule_decision.
            gate = self.length >= self.pseg + W
            if not gate:
                return StepPlan(fire=False, w_t=W)
            n_keep = max(0, min(self.pseg + W - r, self.keep_cap,
                                self.length - r))
            if self.capacity:
                n_keep = min(n_keep, self.capacity - r)
            self.length = n_keep + r
            return StepPlan(fire=True, n_keep=n_keep, w_t=W)
        if m == "fixed":
            w_t = W
            gate = self.length >= self.pseg + W
            fire = gate
        elif m in ("linear", "jump"):
            # Counter increments per layer call BEFORE the gate; within one
            # step all L calls see the same W(t) (floor((s*L + l) /
            # (delta*L)) == s // delta).
            w_t = r + self.step_counter // thresh
            self.step_counter += self.L
            gate = self.length >= self.pseg + w_t
            if m == "linear":
                fire = gate
            else:
                fire = False
                if gate:
                    if self.jump_step < thresh:
                        self.jump_step += self.L
                    else:
                        # Wave: all L layers compress this step, then the
                        # counters reset.
                        fire = True
                        self.jump_step = 0
                        self.jump_layer = 0
        else:
            raise ValueError(f"metric {m} is not host-schedulable")

        if not fire:
            return StepPlan(fire=False, w_t=w_t)
        n_keep = max(0, min(w_t - r, self.keep_cap,
                            self.length - r - self.pseg))
        self.length = self.pseg + n_keep + r
        return StepPlan(fire=True, n_keep=n_keep, w_t=w_t)

    # -- chunk planning ------------------------------------------------
    def _snapshot(self):
        return (self.length, self.step_counter, self.jump_step,
                self.jump_layer)

    def _restore(self, snap):
        (self.length, self.step_counter, self.jump_step,
         self.jump_layer) = snap

    def hot_run_length(self, max_n: int) -> int:
        """How many of the next ``max_n`` steps are fire-free.

        Peeks by simulating plan_step on the mirror and restoring it; the
        caller can then run one multi-step hot chunk over that stretch
        (``llama.decode_steps``) and advance the mirror with
        ``advance_hot(n)``."""
        snap = self._snapshot()
        n = 0
        while n < max_n and not self.plan_step().fire:
            n += 1
        self._restore(snap)
        return n

    def advance_hot(self, n: int):
        """Advance the mirror over ``n`` known-fire-free steps."""
        for _ in range(n):
            if self.plan_step().fire:
                raise RuntimeError("advance_hot crossed a fire step")
