// Continuous-batching slot scheduler (serving runtime core).
//
// The reference processes requests strictly one-by-one
// (run_longgenbench.py:155, eval_batch_size=1).  This scheduler manages a
// fixed pool of decode slots for the batched engine: FIFO admission with a
// token-budget guard, slot lifecycle (free -> active -> draining), and
// aggregate accounting.  Exposed via a C ABI (ctypes, in
// scope_tpu_torch/native/__init__.py); the Python serving loop
// (scope_tpu_torch/engine/serving.py) drives the device work.  Built by
// scope_tpu_torch/ops/build.py with the host C++ compiler.
//
// The scheduler is deliberately allocation-free after construction and
// O(1) per operation so a host loop can consult it every decode step.

#include <cstdint>
#include <cstring>
#include <new>

namespace {

struct Request {
  int64_t id;
  int32_t prompt_len;
  int32_t max_new;
  int32_t generated;
  int32_t slot;        // -1 while queued
};

struct Scheduler {
  int32_t max_slots;
  int64_t token_budget;      // max total live tokens (prompt+generated)
  int64_t next_id;
  int32_t queue_cap;

  Request* queue;            // FIFO ring of pending requests
  int32_t q_head, q_len;
  Request* slots;            // slot table; id == -1 means free
  int64_t live_tokens;
};

inline Request* slot_at(Scheduler* s, int i) { return &s->slots[i]; }

}  // namespace

extern "C" {

void* scope_sched_create(int32_t max_slots, int64_t token_budget,
                         int32_t queue_cap) {
  auto* s = new (std::nothrow) Scheduler();
  if (!s) return nullptr;
  s->max_slots = max_slots;
  s->token_budget = token_budget;
  s->next_id = 1;
  s->queue_cap = queue_cap;
  s->queue = new (std::nothrow) Request[queue_cap];
  s->slots = new (std::nothrow) Request[max_slots];
  if (!s->queue || !s->slots) {
    delete[] s->queue;
    delete[] s->slots;
    delete s;
    return nullptr;
  }
  s->q_head = 0;
  s->q_len = 0;
  s->live_tokens = 0;
  for (int i = 0; i < max_slots; ++i) s->slots[i].id = -1;
  return s;
}

void scope_sched_destroy(void* h) {
  auto* s = static_cast<Scheduler*>(h);
  if (!s) return;
  delete[] s->queue;
  delete[] s->slots;
  delete s;
}

// Enqueue a request; returns its id, or -1 if the queue is full.
int64_t scope_sched_submit(void* h, int32_t prompt_len, int32_t max_new) {
  auto* s = static_cast<Scheduler*>(h);
  if (s->q_len >= s->queue_cap) return -1;
  int idx = (s->q_head + s->q_len) % s->queue_cap;
  s->queue[idx] = Request{s->next_id, prompt_len, max_new, 0, -1};
  s->q_len += 1;
  return s->next_id++;
}

// Try to admit the next queued request: returns the slot index (and
// writes the request id to *out_id), or -1 if nothing can be admitted
// (empty queue, no free slot, or token budget exceeded).
int32_t scope_sched_admit(void* h, int64_t* out_id,
                          int32_t* out_prompt_len, int32_t* out_max_new) {
  auto* s = static_cast<Scheduler*>(h);
  if (s->q_len == 0) return -1;
  Request& r = s->queue[s->q_head];
  if (s->live_tokens + r.prompt_len + r.max_new > s->token_budget)
    return -1;
  for (int i = 0; i < s->max_slots; ++i) {
    if (s->slots[i].id == -1) {
      s->q_head = (s->q_head + 1) % s->queue_cap;
      s->q_len -= 1;
      r.slot = i;
      s->slots[i] = r;
      s->live_tokens += r.prompt_len + r.max_new;
      *out_id = r.id;
      *out_prompt_len = r.prompt_len;
      *out_max_new = r.max_new;
      return i;
    }
  }
  return -1;
}

// Record one generated token for a slot; returns 1 if the request is now
// finished (hit max_new), else 0.
int32_t scope_sched_step(void* h, int32_t slot) {
  auto* s = static_cast<Scheduler*>(h);
  Request& r = *slot_at(s, slot);
  if (r.id == -1) return 0;
  r.generated += 1;
  return r.generated >= r.max_new ? 1 : 0;
}

// Finish (free) a slot, e.g. on EOS or max_new.  Returns the request id.
int64_t scope_sched_finish(void* h, int32_t slot) {
  auto* s = static_cast<Scheduler*>(h);
  Request& r = *slot_at(s, slot);
  if (r.id == -1) return -1;
  int64_t id = r.id;
  s->live_tokens -= r.prompt_len + r.max_new;
  r.id = -1;
  return id;
}

int32_t scope_sched_active(void* h) {
  auto* s = static_cast<Scheduler*>(h);
  int n = 0;
  for (int i = 0; i < s->max_slots; ++i)
    if (s->slots[i].id != -1) ++n;
  return n;
}

int32_t scope_sched_queued(void* h) {
  return static_cast<Scheduler*>(h)->q_len;
}

int64_t scope_sched_live_tokens(void* h) {
  return static_cast<Scheduler*>(h)->live_tokens;
}

int64_t scope_sched_slot_id(void* h, int32_t slot) {
  return static_cast<Scheduler*>(h)->slots[slot].id;
}

// ---- snapshot / restore (fail-stop recovery) -------------------------
//
// The serving engine keeps a periodic host-side snapshot of its device
// buffers; the scheduler must round-trip alongside so admission order,
// token accounting and request ids survive a restore.  Layout: fixed
// header, then the queue ring normalized to head=0, then the slot table.

struct SnapHeader {
  int64_t next_id;
  int64_t live_tokens;
  int32_t q_len;
  int32_t max_slots;
};

int64_t scope_sched_snapshot(void* h, uint8_t* buf, int64_t cap) {
  auto* s = static_cast<Scheduler*>(h);
  int64_t need = static_cast<int64_t>(sizeof(SnapHeader))
      + static_cast<int64_t>(sizeof(Request)) * (s->q_len + s->max_slots);
  if (!buf || cap < need) return need;   // size query / too small
  SnapHeader hd{s->next_id, s->live_tokens, s->q_len, s->max_slots};
  std::memcpy(buf, &hd, sizeof(hd));
  uint8_t* p = buf + sizeof(hd);
  for (int i = 0; i < s->q_len; ++i) {
    std::memcpy(p, &s->queue[(s->q_head + i) % s->queue_cap],
                sizeof(Request));
    p += sizeof(Request);
  }
  std::memcpy(p, s->slots, sizeof(Request) * s->max_slots);
  return need;
}

int32_t scope_sched_restore(void* h, const uint8_t* buf, int64_t len) {
  auto* s = static_cast<Scheduler*>(h);
  SnapHeader hd;
  if (len < static_cast<int64_t>(sizeof(hd))) return -1;
  std::memcpy(&hd, buf, sizeof(hd));
  if (hd.max_slots != s->max_slots || hd.q_len > s->queue_cap) return -1;
  int64_t need = static_cast<int64_t>(sizeof(hd))
      + static_cast<int64_t>(sizeof(Request)) * (hd.q_len + hd.max_slots);
  if (len < need) return -1;
  s->next_id = hd.next_id;
  s->live_tokens = hd.live_tokens;
  s->q_head = 0;
  s->q_len = hd.q_len;
  const uint8_t* p = buf + sizeof(hd);
  std::memcpy(s->queue, p, sizeof(Request) * hd.q_len);
  p += sizeof(Request) * hd.q_len;
  std::memcpy(s->slots, p, sizeof(Request) * s->max_slots);
  return 0;
}

}  // extern "C"
