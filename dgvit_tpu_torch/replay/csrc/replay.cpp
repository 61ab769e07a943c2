// Prioritized ring replay buffer, the equivalent of cpprb's
// PrioritizedReplayBuffer (reference: DRL.py:14,80-100).
//
// Design: a multi-field byte ring (schema-agnostic; Python owns dtypes and
// shapes, C++ owns the ring/cursor/sum-tree) plus a sum-tree proportional
// sampler. Matches cpprb behavior the reference relies on:
//   * new transitions enter with the running max priority (1.0 initially)
//   * the reference never calls update_priorities (DRL.py:365-368 commented
//     out), so all priorities stay equal and sampling is uniform — priorities
//     are fully supported for the PER-enabled configuration.
//   * circular overwrite once capacity is reached, FIFO order.
//
// C API (ctypes-friendly), single-threaded; the Python wrapper serializes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <random>
#include <vector>

namespace {

struct SumTree {
  // binary indexed: leaves [cap, 2*cap)
  int64_t cap = 0;
  std::vector<double> tree;

  void init(int64_t capacity) {
    cap = 1;
    while (cap < capacity) cap <<= 1;
    tree.assign(2 * cap, 0.0);
  }
  void set(int64_t i, double v) {
    int64_t node = cap + i;
    tree[node] = v;
    for (node >>= 1; node >= 1; node >>= 1)
      tree[node] = tree[2 * node] + tree[2 * node + 1];
  }
  double get(int64_t i) const { return tree[cap + i]; }
  double total() const { return tree[1]; }
  // find leaf with prefix-sum >= u
  int64_t find(double u) const {
    int64_t node = 1;
    while (node < cap) {
      double left = tree[2 * node];
      if (u < left) {
        node = 2 * node;
      } else {
        u -= left;
        node = 2 * node + 1;
      }
    }
    return node - cap;
  }
};

struct MinTree {
  // segment tree over leaf priorities; O(log n) set, O(1) min query.
  // Padding / not-yet-stored leaves stay +inf so they never win the min.
  int64_t cap = 0;
  std::vector<double> tree;

  void init(int64_t capacity) {
    cap = 1;
    while (cap < capacity) cap <<= 1;
    tree.assign(2 * cap, std::numeric_limits<double>::infinity());
  }
  void set(int64_t i, double v) {
    int64_t node = cap + i;
    tree[node] = v;
    for (node >>= 1; node >= 1; node >>= 1)
      tree[node] = std::min(tree[2 * node], tree[2 * node + 1]);
  }
  double min() const { return tree[1]; }
};

struct Buffer {
  int64_t capacity = 0;
  int64_t cursor = 0;     // next write slot
  int64_t stored = 0;     // number of valid transitions
  std::vector<int64_t> elem_nbytes;       // per field
  std::vector<std::vector<uint8_t>> data; // per field: capacity * elem_nbytes
  SumTree tree;
  MinTree min_tree;
  double max_priority = 1.0;
  double alpha = 0.6;     // cpprb default priority exponent
  std::mt19937_64 rng{0x5eed};
};

}  // namespace

extern "C" {

void* rb_create(int64_t capacity, int64_t n_fields,
                const int64_t* field_nbytes, double alpha, uint64_t seed) {
  auto* b = new Buffer();
  b->capacity = capacity;
  b->alpha = alpha;
  b->rng.seed(seed);
  b->elem_nbytes.assign(field_nbytes, field_nbytes + n_fields);
  b->data.resize(n_fields);
  for (int64_t f = 0; f < n_fields; ++f)
    b->data[f].resize(static_cast<size_t>(capacity) * field_nbytes[f]);
  b->tree.init(capacity);
  b->min_tree.init(capacity);
  return b;
}

void rb_destroy(void* h) { delete static_cast<Buffer*>(h); }

int64_t rb_stored_size(void* h) { return static_cast<Buffer*>(h)->stored; }
int64_t rb_capacity(void* h) { return static_cast<Buffer*>(h)->capacity; }
int64_t rb_cursor(void* h) { return static_cast<Buffer*>(h)->cursor; }

// Add n transitions; field_ptrs[f] points at n contiguous elements of field f.
void rb_add(void* h, int64_t n, const void** field_ptrs) {
  auto* b = static_cast<Buffer*>(h);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t slot = b->cursor;
    for (size_t f = 0; f < b->data.size(); ++f) {
      const int64_t nb = b->elem_nbytes[f];
      std::memcpy(b->data[f].data() + slot * nb,
                  static_cast<const uint8_t*>(field_ptrs[f]) + i * nb,
                  static_cast<size_t>(nb));
    }
    // new samples get max priority (cpprb semantics)
    const double p = std::pow(b->max_priority, b->alpha);
    b->tree.set(slot, p);
    b->min_tree.set(slot, p);
    b->cursor = (b->cursor + 1) % b->capacity;
    b->stored = std::min(b->stored + 1, b->capacity);
  }
}

// Uniform sampling with replacement (the reference's effective behavior).
void rb_sample_uniform(void* h, int64_t n, int64_t* out_idx) {
  auto* b = static_cast<Buffer*>(h);
  std::uniform_int_distribution<int64_t> dist(0, b->stored - 1);
  for (int64_t i = 0; i < n; ++i) out_idx[i] = dist(b->rng);
}

// Proportional prioritized sampling + importance weights (PER).
void rb_sample_prioritized(void* h, int64_t n, double beta,
                           int64_t* out_idx, double* out_weights) {
  auto* b = static_cast<Buffer*>(h);
  const double total = b->tree.total();
  std::uniform_real_distribution<double> dist(0.0, total);
  // O(1) min via the parallel min-tree (was an O(stored) scan per call —
  // wrong shape for 1M-transition buffers)
  const double min_p = b->min_tree.min();
  const double max_w = std::pow(min_p / total * b->stored, -beta);
  for (int64_t i = 0; i < n; ++i) {
    int64_t idx = b->tree.find(dist(b->rng));
    if (idx >= b->stored) idx = b->stored - 1;  // padding leaves
    out_idx[i] = idx;
    const double p = b->tree.get(idx) / total;
    out_weights[i] = std::pow(p * b->stored, -beta) / max_w;
  }
}

void rb_update_priorities(void* h, int64_t n, const int64_t* idx,
                          const double* prio) {
  auto* b = static_cast<Buffer*>(h);
  for (int64_t i = 0; i < n; ++i) {
    b->max_priority = std::max(b->max_priority, prio[i]);
    const double p = std::pow(prio[i], b->alpha);
    b->tree.set(idx[i], p);
    b->min_tree.set(idx[i], p);
  }
}

// Gather n elements of one field into out (n * elem_nbytes bytes).
void rb_gather(void* h, int64_t field, int64_t n, const int64_t* idx,
               void* out) {
  auto* b = static_cast<Buffer*>(h);
  const int64_t nb = b->elem_nbytes[field];
  auto* dst = static_cast<uint8_t*>(out);
  const auto* src = b->data[field].data();
  for (int64_t i = 0; i < n; ++i)
    std::memcpy(dst + i * nb, src + idx[i] * nb, static_cast<size_t>(nb));
}

// Bulk export of the valid region in FIFO order (for save_transitions).
void rb_export(void* h, int64_t field, void* out) {
  auto* b = static_cast<Buffer*>(h);
  const int64_t nb = b->elem_nbytes[field];
  auto* dst = static_cast<uint8_t*>(out);
  const auto* src = b->data[field].data();
  if (b->stored < b->capacity) {
    std::memcpy(dst, src, static_cast<size_t>(b->stored * nb));
  } else {
    // oldest element sits at cursor
    const int64_t tail = b->capacity - b->cursor;
    std::memcpy(dst, src + b->cursor * nb, static_cast<size_t>(tail * nb));
    std::memcpy(dst + tail * nb, src, static_cast<size_t>(b->cursor * nb));
  }
}

}  // extern "C"
