// Native host-side NB-LDPC core: GF tables, layered bubble-check EMS decoder.
//
// Role in the framework (mirrors the reference's native runtime, but as a
// clean-room C++ implementation):
//   * fast behavioral oracle for the JAX decoders (same algorithm as
//     ems_nbldpc_tpu/golden.py, orders of magnitude faster, double precision)
//   * a CPU oracle callable from Python via ctypes, off the main path
//
// Algorithm: layered EMS with nm-truncated sorted messages and the 8-bubble
// elementary check operator with an nbOper candidate budget — the behavior of
// /root/reference/NB_LDPC.c:313-472 + bubble_decoder.c:72-593, written fresh
// against the framework's polynomial representation (GF add = XOR).
//
// Build: make -C csrc   (produces libnbldpc.so)

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>
#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr double kBig = 1e5;

struct GFTables {
  int q = 0;
  std::vector<int> logt;   // logt[poly] = exponent, logt[0] = -1
  std::vector<int> expt;   // expt[e] = poly value of alpha^e
};

int prim_poly(int q) {
  switch (q) {
    case 4: return 0b111;
    case 8: return 0b1011;
    case 16: return 0b10011;
    case 32: return 0b100101;
    case 64: return 0b1000011;
    case 128: return 0b10000011;
    case 256: return 0b100011101;
    default: return 0;
  }
}

GFTables build_tables(int q) {
  GFTables t;
  t.q = q;
  t.logt.assign(q, -1);
  t.expt.assign(q - 1, 0);
  int prim = prim_poly(q);
  int v = 1;
  for (int i = 0; i < q - 1; ++i) {
    t.expt[i] = v;
    t.logt[v] = i;
    v <<= 1;
    if (v & q) v ^= prim;
  }
  return t;
}

inline int gf_mul(const GFTables& t, int a, int b) {
  if (a == 0 || b == 0) return 0;
  return t.expt[(t.logt[a] + t.logt[b]) % (t.q - 1)];
}

inline int gf_div(const GFTables& t, int a, int b) {
  if (a == 0) return 0;
  int e = t.logt[a] - t.logt[b];
  int m = t.q - 1;
  return t.expt[((e % m) + m) % m];
}

struct Code {
  int q, n, m, dc_max, n_edges;
  std::vector<int> row_deg;            // [m]
  std::vector<int> row_cols;           // [m * dc_max]
  std::vector<int> row_coefs;          // [m * dc_max] poly rep
  std::vector<int> edge_offset;        // [m + 1]
  GFTables gf;
};

// Sorted truncated message: ascending costs + distinct GF symbols.
struct TruncMsg {
  std::vector<double> val;
  std::vector<int> gfv;  // -1 = unfilled
};

// Selection of the nm smallest entries of a dense message, min-normalized
// (reference sort-truncate, NB_LDPC.c:354-374).
void sort_truncate(const double* dense, int q, int nm, TruncMsg* out) {
  out->val.resize(nm);
  out->gfv.resize(nm);
  std::vector<int> idx(q);
  for (int i = 0; i < q; ++i) idx[i] = i;
  std::partial_sort(idx.begin(), idx.begin() + nm, idx.end(),
                    [&](int a, int b) {
                      return dense[a] < dense[b] ||
                             (dense[a] == dense[b] && a < b);
                    });
  double base = dense[idx[0]];
  for (int k = 0; k < nm; ++k) {
    out->val[k] = dense[idx[k]] - base;
    out->gfv[k] = idx[k];
  }
}

// The 8-bubble elementary check operator with candidate budget
// (behavior of bubble_decoder.c:316-593).
void elementary_bubble(const TruncMsg& in1, const TruncMsg& in2, int nm,
                       int nb_oper, std::vector<uint8_t>* seen_buf,
                       TruncMsg* out) {
  constexpr int kBubbles = 8;
  constexpr int kHalf = kBubbles / 2;
  out->val.assign(nm, kBig);
  out->gfv.assign(nm, -1);
  auto& seen = *seen_buf;
  std::fill(seen.begin(), seen.end(), 0);

  struct Bubble {
    double v;
    int i, j;
    bool down;  // true: advances i; false: advances j
  };
  Bubble bub[kBubbles];
  auto cand = [&](int i, int j) -> double {
    if (in1.gfv[i] < 0 || in2.gfv[j] < 0) return kBig;
    return in1.val[i] + in2.val[j];
  };
  for (int r = 0; r < kHalf; ++r) bub[r] = {cand(r, 0), r, 0, false};
  for (int c = 0; c < kHalf; ++c) bub[kHalf + c] = {cand(kHalf, c), kHalf, c, true};

  int s = 0;
  for (int op = 0; op < nb_oper; ++op) {
    int best = 0;
    for (int b = 1; b < kBubbles; ++b)
      if (bub[b].v < bub[best].v) best = b;
    Bubble& w = bub[best];
    if (in1.gfv[w.i] < 0 || in2.gfv[w.j] < 0) break;
    int gf = in1.gfv[w.i] ^ in2.gfv[w.j];
    if (!seen[gf]) {
      seen[gf] = 1;
      out->val[s] = w.v;
      out->gfv[s] = gf;
      if (++s == nm) break;
    }
    if (w.i >= nm - 1 || w.j >= nm - 1) break;  // bubble boundary rule
    if (w.down) ++w.i; else ++w.j;
    w.v = cand(w.i, w.j);
  }
}

struct Workspace {
  std::vector<double> app;        // [n * q]
  std::vector<double> ctov;       // [n_edges * q]
  std::vector<TruncMsg> vin;      // [dc]
  std::vector<TruncMsg> fwd, bwd; // [dc]
  TruncMsg merged;
  std::vector<uint8_t> seen;      // [q]
  std::vector<int> decide;        // [n]
  std::vector<double> mvc;        // [dc * q]
};

bool syndrome_ok(const Code& c, const std::vector<int>& decide) {
  for (int r = 0; r < c.m; ++r) {
    int acc = 0;
    const int d = c.row_deg[r];
    for (int t = 0; t < d; ++t) {
      acc ^= gf_mul(c.gf, c.row_coefs[r * c.dc_max + t],
                    decide[c.row_cols[r * c.dc_max + t]]);
    }
    if (acc != 0) return false;
  }
  return true;
}

// One frame, layered schedule. Returns iterations used; decide in ws.decide.
int decode_frame(const Code& c, const double* intrinsic, int max_iters,
                 int nm, double offset, int nb_oper, Workspace& ws,
                 bool* converged) {
  const int q = c.q;
  ws.app.assign(intrinsic, intrinsic + c.n * q);
  ws.ctov.assign((size_t)c.n_edges * q, 0.0);
  ws.decide.resize(c.n);
  ws.seen.assign(q, 0);
  ws.vin.resize(c.dc_max);
  ws.fwd.resize(c.dc_max);
  ws.bwd.resize(c.dc_max);
  ws.mvc.resize((size_t)c.dc_max * q);

  auto decide_all = [&]() {
    for (int v = 0; v < c.n; ++v) {
      const double* row = &ws.app[(size_t)v * q];
      int best = 0;
      for (int g = 1; g < q; ++g)
        if (row[g] < row[best]) best = g;
      ws.decide[v] = best;
    }
  };
  decide_all();
  if (syndrome_ok(c, ws.decide)) { *converged = true; return 0; }

  for (int iter = 0; iter < max_iters; ++iter) {
    for (int r = 0; r < c.m; ++r) {
      const int d = c.row_deg[r];
      const int e0 = c.edge_offset[r];
      // VN extrinsic + sort-truncate + rotate in
      for (int t = 0; t < d; ++t) {
        const int col = c.row_cols[r * c.dc_max + t];
        const int h = c.row_coefs[r * c.dc_max + t];
        double* mvc = &ws.mvc[(size_t)t * q];
        const double* app = &ws.app[(size_t)col * q];
        const double* cv = &ws.ctov[(size_t)(e0 + t) * q];
        for (int g = 0; g < q; ++g) mvc[g] = app[g] - cv[g];
        sort_truncate(mvc, q, nm, &ws.vin[t]);
        for (int k = 0; k < nm; ++k)
          ws.vin[t].gfv[k] = gf_mul(c.gf, h, ws.vin[t].gfv[k]);
      }
      // forward/backward recursion
      ws.fwd[0] = ws.vin[0];
      ws.bwd[d - 1] = ws.vin[d - 1];
      for (int t = 1; t < d - 1; ++t) {
        elementary_bubble(ws.fwd[t - 1], ws.vin[t], nm, nb_oper, &ws.seen,
                          &ws.fwd[t]);
        int u = d - 1 - t;
        elementary_bubble(ws.bwd[u + 1], ws.vin[u], nm, nb_oper, &ws.seen,
                          &ws.bwd[u]);
      }
      // per-edge output: merge, un-rotate, dense-expand with saturation,
      // write CtoV and APP (NB_LDPC.c:414-450)
      for (int t = 0; t < d; ++t) {
        const TruncMsg* outm;
        if (t == 0) outm = &ws.bwd[1];
        else if (t == d - 1) outm = &ws.fwd[d - 2];
        else {
          elementary_bubble(ws.fwd[t - 1], ws.bwd[t + 1], nm, nb_oper,
                            &ws.seen, &ws.merged);
          outm = &ws.merged;
        }
        int stp = 0;
        while (stp < nm && outm->gfv[stp] >= 0) ++stp;
        const int col = c.row_cols[r * c.dc_max + t];
        const int h = c.row_coefs[r * c.dc_max + t];
        double* cv = &ws.ctov[(size_t)(e0 + t) * q];
        double* app = &ws.app[(size_t)col * q];
        const double* mvc = &ws.mvc[(size_t)t * q];
        double sat = (stp > 0 ? outm->val[stp - 1] : 0.0) + offset;
        for (int g = 0; g < q; ++g) cv[g] = sat;
        for (int k = 0; k < stp; ++k)
          cv[gf_div(c.gf, outm->gfv[k], h)] = outm->val[k];
        for (int g = 0; g < q; ++g) app[g] = cv[g] + mvc[g];
      }
    }
    decide_all();
    if (syndrome_ok(c, ws.decide)) { *converged = true; return iter + 1; }
  }
  *converged = false;
  return max_iters;
}

}  // namespace

extern "C" {

// Batched layered EMS decode.
// intrinsic: [frames, n, q] row-major doubles (min-cost convention).
// decisions: [frames, n] int32 out. iters: [frames] int32 out.
// converged: [frames] uint8 out. Returns 0 on success.
int nbldpc_decode_batch(
    int q, int n, int m, int dc_max, const int* row_deg, const int* row_cols,
    const int* row_coefs, int frames, const double* intrinsic, int max_iters,
    int nm, double offset, int nb_oper, int* decisions, int* iters,
    uint8_t* converged) {
  if (prim_poly(q) == 0 || nm < 1 || nm > q) return 1;
  Code c;
  c.q = q; c.n = n; c.m = m; c.dc_max = dc_max;
  c.row_deg.assign(row_deg, row_deg + m);
  c.row_cols.assign(row_cols, row_cols + (size_t)m * dc_max);
  c.row_coefs.assign(row_coefs, row_coefs + (size_t)m * dc_max);
  c.edge_offset.resize(m + 1);
  c.edge_offset[0] = 0;
  for (int r = 0; r < m; ++r)
    c.edge_offset[r + 1] = c.edge_offset[r] + row_deg[r];
  c.n_edges = c.edge_offset[m];
  c.gf = build_tables(q);

#ifdef _OPENMP
#pragma omp parallel
  {
    Workspace ws;
#pragma omp for schedule(dynamic)
    for (int f = 0; f < frames; ++f) {
      bool conv = false;
      int it = decode_frame(c, intrinsic + (size_t)f * n * q, max_iters, nm,
                            offset, nb_oper, ws, &conv);
      iters[f] = it;
      converged[f] = conv ? 1 : 0;
      std::memcpy(decisions + (size_t)f * n, ws.decide.data(),
                  sizeof(int) * n);
    }
  }
#else
  Workspace ws;
  for (int f = 0; f < frames; ++f) {
    bool conv = false;
    int it = decode_frame(c, intrinsic + (size_t)f * n * q, max_iters, nm,
                          offset, nb_oper, ws, &conv);
    iters[f] = it;
    converged[f] = conv ? 1 : 0;
    std::memcpy(decisions + (size_t)f * n, ws.decide.data(),
                sizeof(int) * n);
  }
#endif
  return 0;
}

// Expose the elementary step for unit tests against the Python golden model.
int nbldpc_elementary_step(
    int q, int nm, int nb_oper, const double* v1, const int* g1,
    const double* v2, const int* g2, double* out_v, int* out_g) {
  if (prim_poly(q) == 0) return 1;
  TruncMsg a, b, o;
  a.val.assign(v1, v1 + nm); a.gfv.assign(g1, g1 + nm);
  b.val.assign(v2, v2 + nm); b.gfv.assign(g2, g2 + nm);
  std::vector<uint8_t> seen(q, 0);
  elementary_bubble(a, b, nm, nb_oper, &seen, &o);
  std::copy(o.val.begin(), o.val.end(), out_v);
  std::copy(o.gfv.begin(), o.gfv.end(), out_g);
  return 0;
}

}  // extern "C"
