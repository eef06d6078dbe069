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

A copy of the JAX package's ``compression/host_sched.py``: the
layer-uniform methods' mirror (:class:`HostScheduler`), without its
lazy-eviction mirror (the physical fill pointer and the compaction
schedule), which the port does not need (ROADMAP §1 item 11),
pyramidkv's per-layer mirror (:class:`LayeredHostScheduler`,
:func:`pyramid_prefill_kept`) and Quest's (:class:`QuestHostScheduler`),
whose skip layers never compress and never advance the counters.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

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


def pyramid_prefill_kept(comp: CompressionConfig, num_layers: int,
                         prompt_len: int, prompt_bucket: int) -> List[int]:
    """The PyramidKV prefill kept count of each layer, as
    ``compress_prefill``'s pyramidkv branch keeps it.  prompt_bucket is the
    padded prompt length S_pad (nothing is compressed when S_pad <= P)."""
    P, w, beta = comp.max_capacity_prompt, comp.window_size, comp.beta
    if prompt_bucket <= P or prompt_len < P:
        return [prompt_len] * num_layers
    q_len = prompt_len
    min_num = (P - w) // beta
    max_num = (P - w) * 2 - min_num
    over = max_num >= q_len - w
    max_num_d = (q_len - w) if over else max_num
    lo = ((P - w) * 2 - max_num_d) if over else min_num
    steps = (max_num_d - lo) // num_layers
    mid = q_len < (P - w) * 2
    kept = []
    for l in range(num_layers):
        n_keep = P if mid else max_num_d - l * steps
        kept.append(max(0, min(n_keep, q_len - w)) + w)
    return kept


@dataclass
class StepPlan:
    fire: bool
    n_keep: int = 0          # tokens kept from the scored region
    w_t: int = 0             # current decode window budget


@dataclass
class LayeredStepPlan:
    fire_any: bool
    fire: List[bool]         # [L]
    n_keep: List[int]        # [L]


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


class LayeredHostScheduler:
    """Per-layer host mirror for PyramidKV's layer-decayed budgets.

    Prefill keeps a different count per layer, so each layer's cache
    length, and so its fire step, differs.  The counters stay scalar
    (reference class attributes): one increment per layer call, as
    ``schedulers.schedule_decision`` makes them.  ``capacity`` is the
    port's pyramidkv capacity (``EngineConfig.cache_capacity``)."""

    def __init__(self, comp: CompressionConfig, num_layers: int,
                 prompt_len: int, prompt_pad: int, keep_cap: int,
                 capacity: int):
        self.comp = comp
        self.L = num_layers
        self.pseg = comp.max_capacity_prompt
        self.lengths = pyramid_prefill_kept(comp, num_layers, prompt_len,
                                            prompt_pad)
        self.keep_cap = min(keep_cap, capacity)
        self.capacity = capacity
        self.step_counter = 0
        self.jump_step = 0
        self.jump_layer = 0

    def plan_step(self) -> LayeredStepPlan:
        """Advance one decode step; each layer's gate sees its appended
        length."""
        comp = self.comp
        m = comp.decoding_metric
        W = comp.decoding_window_size
        r = comp.decoding_recent_size
        P = comp.max_capacity_prompt
        thresh = comp.delta * self.L
        fire = [False] * self.L
        n_keep = [0] * self.L
        for l in range(self.L):
            self.lengths[l] += 1
            if m == "none":
                continue
            if m == "pyramidinfer":
                # Decode-phase pyramid budgets, rewritten from slot 0;
                # mirrors schedule_decision's pyramidinfer arm.
                if self.lengths[l] < self.pseg + W:
                    continue
                min_num = (P + W - r) // 2
                max_num = (P + W - r) * 2 - min_num
                steps = (max_num - min_num) // self.L
                mid = self.lengths[l] < (P - r) * 2 + W
                nk = (P + W - r) if mid else (max_num - l * steps + W)
                nk = max(0, min(nk, self.lengths[l] - r, self.keep_cap,
                                self.capacity - r))
                n_keep[l] = nk
                fire[l] = True
                self.lengths[l] = nk + r
                continue
            if m == "fixed":
                w_t = W
                f = self.lengths[l] >= self.pseg + W
            else:
                w_t = r + self.step_counter // thresh
                self.step_counter += 1
                gate = self.lengths[l] >= self.pseg + w_t
                if m == "linear":
                    f = gate
                else:            # jump: the wave machinery per layer call
                    counting = gate and self.jump_step < thresh
                    wave = gate and self.jump_step >= thresh
                    if counting:
                        self.jump_step += 1
                    if wave:
                        self.jump_layer += 1
                    if self.jump_layer >= self.L:
                        self.jump_step = 0
                        self.jump_layer = 0
                    f = gate and wave
            if f:
                nk = max(0, min(w_t - r,
                                max(self.lengths[l] - r - self.pseg, 0)))
                nk = min(nk, self.keep_cap, self.capacity - r - self.pseg)
                n_keep[l] = nk
                fire[l] = True
                self.lengths[l] = self.pseg + nk + r
        return LayeredStepPlan(fire_any=any(fire), fire=fire, n_keep=n_keep)

    # -- chunk planning (see HostScheduler) -----------------------------
    def _snapshot(self):
        return (list(self.lengths), self.step_counter, self.jump_step,
                self.jump_layer)

    def _restore(self, snap):
        lengths, self.step_counter, self.jump_step, self.jump_layer = snap
        self.lengths = list(lengths)

    def hot_run_length(self, max_n: int) -> int:
        snap = self._snapshot()
        n = 0
        while n < max_n and not self.plan_step().fire_any:
            n += 1
        self._restore(snap)
        return n

    def advance_hot(self, n: int):
        for _ in range(n):
            if self.plan_step().fire_any:
                raise RuntimeError("advance_hot crossed a fire step")

    @property
    def length(self) -> int:
        """The longest layer's length (the hot step's length bucket)."""
        return max(self.lengths)


class QuestHostScheduler(LayeredHostScheduler):
    """Host mirror of Quest's decode-region gates
    (``compression/quest.quest_decode_layer``).

    The skip layers (``quest_skip_layers``) never compress and never
    advance the shared counters, so a step makes only L - skip counter
    increments: w_t grows more slowly than the other methods', and a jump
    wave needs two steps to reach all L jump_layer increments (the second
    step fires the first wave's layers again; the reference's
    class-attribute arithmetic, reproduced exactly).  Per-layer lengths:
    the skip layers' decode regions grow without bound; a fired layer
    drops to prompt_len + n_keep + r.  Chunk planning and the length
    bucket are :class:`LayeredHostScheduler`'s."""

    def __init__(self, comp: CompressionConfig, num_layers: int,
                 prompt_len: int, keep_cap: int):
        self.comp = comp
        self.L = num_layers
        self.skip = comp.quest_skip_layers
        self.prompt_len = prompt_len
        self.lengths = [prompt_len] * num_layers
        self.keep_cap = keep_cap
        self.step_counter = 0
        self.jump_step = 0
        self.jump_layer = 0

    def plan_step(self) -> LayeredStepPlan:
        """Advance one decode step; each layer's gate sees its appended
        decode-region length."""
        comp = self.comp
        m = comp.decoding_metric
        W = comp.decoding_window_size
        r = comp.decoding_recent_size
        thresh = comp.delta * self.L
        fire = [False] * self.L
        n_keep = [0] * self.L
        for l in range(self.L):
            self.lengths[l] += 1
            if m == "none" or l < self.skip:
                continue
            dk = self.lengths[l] - self.prompt_len
            if m in ("linear", "jump"):
                w_t = r + self.step_counter // thresh
                self.step_counter += 1
            else:                            # fixed
                w_t = W
            gate = dk >= w_t
            if m == "jump":
                counting = gate and self.jump_step < thresh
                wave = gate and self.jump_step >= thresh
                if counting:
                    self.jump_step += 1
                if wave:
                    self.jump_layer += 1
                if self.jump_layer >= self.L:
                    self.jump_step = 0
                    self.jump_layer = 0
                f = gate and wave
            else:
                f = gate
            if f:
                nk = max(0, min(w_t - r, self.keep_cap))
                nk = min(nk, max(dk - r, 0))
                fire[l] = True
                n_keep[l] = nk
                self.lengths[l] = self.prompt_len + nk + r
        return LayeredStepPlan(fire_any=any(fire), fire=fire, n_keep=n_keep)

    @property
    def dec_len(self) -> int:
        """The longest decode region of the page-selecting layers (the
        ``quest_dec_cap`` bucket; the skip layers attend densely, bounded
        by the length bucket instead)."""
        if self.L <= self.skip:
            return 0
        return max(self.lengths[l] - self.prompt_len
                   for l in range(self.skip, self.L))
