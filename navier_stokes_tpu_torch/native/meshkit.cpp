// meshkit: host setup kernels of the PyTorch port, in C++.
//
// The reference delegates its mesh/dof/preconditioner setup to the NGSolve
// C++ library.  The port's device compute path is PyTorch and hand-written
// CUDA; the host-side setup around it uses these C++ kernels for the
// hotspots that are loop-bound in Python:
//
//   * build_edges        - unique-edge connectivity + per-element edge ids
//                          and orientation flips (hash-map, O(ne))
//   * rcm_ordering       - reverse Cuthill-McKee bandwidth reduction on a
//                          CSR adjacency graph
//   * extract_blocks     - dense sub-matrix extraction of overlapping dof
//                          blocks from a CSR matrix (the additive-Schwarz
//                          patch setup)
//
// Plain C ABI, driven through ctypes; compiled on demand with g++ into the
// repository's build/ directory (no pybind11 dependency).  A copy of the
// JAX package's navier_stokes_tpu/native/meshkit.cpp; the loader and the
// scipy/numpy fallbacks are in navier_stokes_tpu_torch/utils/native.py.

#include <cstdint>
#include <cstring>
#include <queue>
#include <unordered_map>
#include <vector>
#include <algorithm>

extern "C" {

// elements: (ne, nodes_per_el) int32; local_edges: (nle, 2) int32 local
// vertex pairs.  Outputs: element_edges (ne, nle) int32, flips (ne, nle)
// uint8; edges_out capacity must be >= ne*nle*2 int32; returns nedge.
int64_t build_edges(
    int64_t ne, int64_t nodes_per_el, const int32_t* elements,
    int64_t nle, const int32_t* local_edges,
    int32_t* element_edges, uint8_t* flips, int32_t* edges_out) {
  std::unordered_map<uint64_t, int32_t> edge_ids;
  edge_ids.reserve(static_cast<size_t>(ne) * nle);
  int32_t nedge = 0;
  for (int64_t e = 0; e < ne; ++e) {
    const int32_t* el = elements + e * nodes_per_el;
    for (int64_t le = 0; le < nle; ++le) {
      int32_t a = el[local_edges[2 * le]];
      int32_t b = el[local_edges[2 * le + 1]];
      bool flip = a > b;
      int32_t lo = flip ? b : a, hi = flip ? a : b;
      uint64_t key = (static_cast<uint64_t>(lo) << 32) | static_cast<uint32_t>(hi);
      auto it = edge_ids.find(key);
      int32_t id;
      if (it == edge_ids.end()) {
        id = nedge++;
        edge_ids.emplace(key, id);
        edges_out[2 * id] = lo;
        edges_out[2 * id + 1] = hi;
      } else {
        id = it->second;
      }
      element_edges[e * nle + le] = id;
      flips[e * nle + le] = flip ? 1 : 0;
    }
  }
  // NOTE: edge ids here are in first-seen order, not the sorted-unique
  // order numpy.unique produces; callers must treat ids as opaque.
  return nedge;
}

// Reverse Cuthill-McKee on a symmetric CSR graph; perm[i] = old index of
// the node placed at new position i.
void rcm_ordering(int64_t n, const int64_t* indptr, const int32_t* indices,
                  int32_t* perm) {
  std::vector<int32_t> degree(n);
  for (int64_t i = 0; i < n; ++i)
    degree[i] = static_cast<int32_t>(indptr[i + 1] - indptr[i]);
  std::vector<uint8_t> visited(n, 0);
  std::vector<int32_t> order;
  order.reserve(n);
  std::vector<int32_t> nbrs;
  for (;;) {
    // next unvisited node of minimal degree (new component seed)
    int32_t seed = -1, best = INT32_MAX;
    for (int64_t i = 0; i < n; ++i) {
      if (!visited[i] && degree[i] < best) { best = degree[i]; seed = (int32_t)i; }
    }
    if (seed < 0) break;
    std::queue<int32_t> q;
    q.push(seed);
    visited[seed] = 1;
    while (!q.empty()) {
      int32_t u = q.front(); q.pop();
      order.push_back(u);
      nbrs.clear();
      for (int64_t k = indptr[u]; k < indptr[u + 1]; ++k) {
        int32_t v = indices[k];
        if (!visited[v]) { visited[v] = 1; nbrs.push_back(v); }
      }
      std::sort(nbrs.begin(), nbrs.end(),
                [&](int32_t a, int32_t b) { return degree[a] < degree[b]; });
      for (int32_t v : nbrs) q.push(v);
    }
  }
  // reverse
  for (int64_t i = 0; i < n; ++i) perm[i] = order[n - 1 - i];
}

// Extract dense sub-blocks A[dofs_b][:, dofs_b] from CSR (indptr int64,
// indices int32, data f64).  blocks: (nblocks, bmax) int32 padded with -1.
// out: (nblocks, bmax, bmax) f64, preinitialized to identity by caller.
void extract_blocks(
    int64_t n, const int64_t* indptr, const int32_t* indices,
    const double* data, int64_t nblocks, int64_t bmax,
    const int32_t* blocks, double* out) {
  std::vector<int32_t> pos(n, -1);
  for (int64_t b = 0; b < nblocks; ++b) {
    const int32_t* dofs = blocks + b * bmax;
    int64_t sz = 0;
    while (sz < bmax && dofs[sz] >= 0) ++sz;
    for (int64_t i = 0; i < sz; ++i) pos[dofs[i]] = static_cast<int32_t>(i);
    double* blk = out + b * bmax * bmax;
    // zero the live sub-block (caller pre-initializes the full array to
    // identity so PADDING rows/cols stay invertible; structurally-zero
    // entries inside the block must not inherit that identity)
    for (int64_t i = 0; i < sz; ++i)
      for (int64_t j = 0; j < sz; ++j) blk[i * bmax + j] = 0.0;
    for (int64_t i = 0; i < sz; ++i) {
      int32_t row = dofs[i];
      for (int64_t k = indptr[row]; k < indptr[row + 1]; ++k) {
        int32_t p = pos[indices[k]];
        if (p >= 0) blk[i * bmax + p] = data[k];
      }
    }
    for (int64_t i = 0; i < sz; ++i) pos[dofs[i]] = -1;
  }
}

}  // extern "C"
