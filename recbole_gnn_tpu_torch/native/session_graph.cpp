// Native host-side session-graph preprocessing.
//
// C++ replacement for the hottest host path: per-session unique/alias/
// edge construction over hundreds of thousands of augmented sessions
// (the reference runs per-session Python loops with tqdm,
// recbole_gnn/data/dataset.py:122-129; our numpy path vectorizes but
// still burns chunked O(N·L²) broadcasts).  Exposed as plain C symbols
// for ctypes; all buffers are caller-allocated numpy arrays.
//
// Layout contract (matches recbole_gnn_tpu_torch/data/session.py):
//   x[r]      : sorted unique items, left-compacted, 0-padded
//   alias[r]  : node slot per sequence position; padded positions get
//               min(n_nodes, L-1)
//   edges     : deduped consecutive pairs in (src·L + dst) sorted order
//
// Built at first use by recbole_gnn_tpu_torch/native/__init__.py
// (g++ -O3 -std=c++17 -fPIC -shared -pthread).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

void build_rows(const int32_t* seqs, const int32_t* lengths, int64_t n_rows,
                int32_t L, int32_t* x, int32_t* n_nodes, int32_t* alias,
                int32_t* edge_src, int32_t* edge_dst, int32_t* n_edges,
                int64_t row_begin, int64_t row_end) {
  std::vector<int32_t> uniq;
  std::vector<int64_t> keys;
  uniq.reserve(L);
  keys.reserve(L);
  for (int64_t r = row_begin; r < row_end; ++r) {
    const int32_t* seq = seqs + r * L;
    const int32_t len = lengths[r];

    uniq.assign(seq, seq + len);
    std::sort(uniq.begin(), uniq.end());
    uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
    const int32_t nn = static_cast<int32_t>(uniq.size());
    n_nodes[r] = nn;

    int32_t* xr = x + r * L;
    std::memset(xr, 0, sizeof(int32_t) * L);
    std::copy(uniq.begin(), uniq.end(), xr);

    int32_t* ar = alias + r * L;
    const int32_t pad_slot = std::min(nn, L - 1);
    for (int32_t p = 0; p < L; ++p) {
      if (p < len) {
        ar[p] = static_cast<int32_t>(
            std::lower_bound(uniq.begin(), uniq.end(), seq[p]) -
            uniq.begin());
      } else {
        ar[p] = pad_slot;
      }
    }

    keys.clear();
    for (int32_t p = 0; p + 1 < len; ++p) {
      keys.push_back(static_cast<int64_t>(ar[p]) * L + ar[p + 1]);
    }
    std::sort(keys.begin(), keys.end());
    keys.erase(std::unique(keys.begin(), keys.end()), keys.end());
    const int32_t ne = static_cast<int32_t>(keys.size());
    n_edges[r] = ne;

    int32_t* sr = edge_src + r * L;
    int32_t* dr = edge_dst + r * L;
    std::memset(sr, 0, sizeof(int32_t) * L);
    std::memset(dr, 0, sizeof(int32_t) * L);
    for (int32_t e = 0; e < ne; ++e) {
      sr[e] = static_cast<int32_t>(keys[e] / L);
      dr[e] = static_cast<int32_t>(keys[e] % L);
    }
  }
}

}  // namespace

extern "C" {

// Session graphs for n_rows padded sequences (n_rows × L each).
// All output buffers are (n_rows × L) int32 except n_nodes / n_edges
// (n_rows).  n_threads <= 0 → hardware concurrency.
void build_session_graphs(const int32_t* seqs, const int32_t* lengths,
                          int64_t n_rows, int32_t L, int32_t* x,
                          int32_t* n_nodes, int32_t* alias,
                          int32_t* edge_src, int32_t* edge_dst,
                          int32_t* n_edges, int32_t n_threads) {
  int nt = n_threads > 0 ? n_threads
                         : static_cast<int>(std::thread::hardware_concurrency());
  if (nt < 1) nt = 1;
  if (n_rows < 4096) nt = 1;
  std::vector<std::thread> workers;
  const int64_t chunk = (n_rows + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = std::min<int64_t>(n_rows, lo + chunk);
    if (lo >= hi) break;
    workers.emplace_back(build_rows, seqs, lengths, n_rows, L, x, n_nodes,
                         alias, edge_src, edge_dst, n_edges, lo, hi);
  }
  for (auto& w : workers) w.join();
}

// Iterative k-core filtering: keep[i]=1 while user/item interaction
// counts stay inside [u_min, u_max] / [i_min, i_max]; loops to a fixed
// point.  Returns the number of surviving interactions.
int64_t kcore_filter(const int64_t* users, const int64_t* items,
                     int64_t n, int64_t n_users, int64_t n_items,
                     int64_t u_min, int64_t u_max, int64_t i_min,
                     int64_t i_max, uint8_t* keep) {
  std::vector<int64_t> ucnt(n_users, 0), icnt(n_items, 0);
  std::memset(keep, 1, n);
  bool changed = true;
  int64_t alive = n;
  while (changed) {
    changed = false;
    std::fill(ucnt.begin(), ucnt.end(), 0);
    std::fill(icnt.begin(), icnt.end(), 0);
    for (int64_t e = 0; e < n; ++e) {
      if (keep[e]) {
        ++ucnt[users[e]];
        ++icnt[items[e]];
      }
    }
    for (int64_t e = 0; e < n; ++e) {
      if (!keep[e]) continue;
      const int64_t uc = ucnt[users[e]];
      const int64_t ic = icnt[items[e]];
      if (uc < u_min || uc > u_max || ic < i_min || ic > i_max) {
        keep[e] = 0;
        --alive;
        changed = true;
      }
    }
  }
  return alive;
}

}  // extern "C"
