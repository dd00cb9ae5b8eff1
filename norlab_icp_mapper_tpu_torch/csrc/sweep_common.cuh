// The packed pair loop: what sweep_knn.cu, knn_brute.cu and radius_pca.cu are
// built from.
//
// Schedule common to the two sorted sweeps (sweep_knn.cu, radius_pca.cu):
// queries and references are sorted by x.  A block owns consecutive sorted
// queries and a contiguous window of the sorted references (every reference
// within the radius of any of the block's queries lies inside; sweep_knn.cu
// is handed its windows, radius_pca.cu finds them by pair_bound_x).  The
// block streams its window through shared memory; every thread reads every
// staged reference (a broadcast read, no bank conflict).  knn_brute.cu is
// the same loop with the whole packed reference array as its window and no
// radius gate.
//
// What bounds the pair loop on an H100, and what the packed form does about
// it.  The distance is 3 subtractions, 3 products and 2 sums, each rounded
// on its own (see pair_dist2), so a pair costs 8 arithmetic instructions
// plus whatever ranks or sums it; a scheduler dispatches one instruction per
// clock for a warp, so 132 SMs x 4 schedulers x 32 lanes x clock /
// (instructions per pair) is the ceiling.  The loop
//   * reads a reference as ONE 128-bit shared-memory load (x, y, z and the
//     bits of its original index in the fourth lane) and uses it for Q
//     queries held in the registers of one thread, so loads and loop
//     bookkeeping are shared by Q pairs;
//   * stages tiles of references (16 bytes each) with cp.async into a two-deep
//     ring: the next tile arrives while this one is consumed, one block
//     barrier per tile;
//   * pads a partial tile in shared memory up to PAIR_GROUP with a
//     reference at x = +inf (its distance is +inf: it ranks nowhere and
//     passes no gate), so the inner loops are unrolled groups without a
//     bound check;
//   * ranks a group of pairs at once: at k = 1 a running minimum (one FMNMX
//     per pair) and a note of the last group that improved it, the index
//     being recovered from that group afterwards; at k > 1 the minimum of a
//     group against the list's worst entry and the query's gate (the
//     sweep's r^2, or a bound on the k-th distance known beforehand), and
//     the sorted insertion only for a group that has a candidate;
//   * sums the moments of the pairs inside the radius (radius_pca.cu), with
//     the references of a tile dealt out to a few lanes per query where the
//     queries alone would leave the schedulers short of warps.
// Measured on an H100 at 1,980 MHz, the k = 1 loop dispatches 9.4 instructions
// per pair and reaches 2.6 Tpair/s, about 70 % of lanes x clock / 9; the
// k > 1 loop without any insertion runs at 3/4 of that.
// Tensor cores are not used: the product has a depth of 3, and the expanded
// form |q|^2 + |r|^2 - 2 q.r in TF32 (or split three ways) loses the digits
// that the tie rule, a 0.15 m gate and bit-identity with the plain version
// need at coordinates of tens of metres.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PAIR_STAGES 2   // depth of the ring of staged tiles
#define PAIR_GROUP 16   // a staged tile is padded to a multiple of this
#define PAIR_THREADS 128  // threads per block of the kernels built on this

#define PAIR_INF __int_as_float(0x7f800000)

// Squared distance to a packed reference, subtract first, every product and
// sum rounded to f32 on its own: the intrinsics stop nvcc from contracting
// `s + d*d` into an FMA.  Eager PyTorch (the plain version) and XLA on the CPU
// do not contract, so with this form kernel and plain version agree bit for
// bit and a pair within an ulp of r^2 falls on the same side of the gate in
// both.
template <int D>
__device__ __forceinline__ float pair_dist2(const float (&q)[D],
                                            const float4 r) {
  const float d0 = __fsub_rn(r.x, q[0]);
  float s = __fmul_rn(d0, d0);
  const float d1 = __fsub_rn(r.y, q[1]);
  s = __fadd_rn(s, __fmul_rn(d1, d1));
  if (D == 3) {
    const float d2 = __fsub_rn(r.z, q[D - 1]);
    s = __fadd_rn(s, __fmul_rn(d2, d2));
  }
  return s;
}

__device__ __forceinline__ void pair_cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void pair_cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start the copy of packed references [base, base + cnt) into one stage of
// the ring (16 bytes a thread and request); the rest of the last group is
// filled with the padding reference.  Completion: pair_cp_async_wait_all()
// followed by a block barrier.
__device__ __forceinline__ void pair_stage_async(float4* stage,
                                                 const float4* __restrict__ ref4,
                                                 int base, int cnt) {
  for (int t = threadIdx.x; t < cnt; t += blockDim.x)
    pair_cp_async16(&stage[t], &ref4[(size_t)base + t]);
  const int padded = (cnt + PAIR_GROUP - 1) & ~(PAIR_GROUP - 1);
  for (int t = cnt + threadIdx.x; t < padded; t += blockDim.x)
    stage[t] = make_float4(PAIR_INF, 0.0f, 0.0f, __int_as_float(-1));
}

// Sorted insertion of (cd, ci) into an ascending list kept in registers: a
// fully unrolled carry chain, so the list is never indexed by a runtime
// value.  Strict `<`: a candidate never displaces an entry of equal
// distance, and candidates arrive in ascending index, so among equal
// distances the lower index stays first.
template <int K>
__device__ __forceinline__ void pair_list_insert(float (&bd)[K], int (&bi)[K],
                                                 float cd, int ci) {
  bool carrying = false;  // once placed, shift the rest down
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const bool sw = carrying || (cd < bd[t]);
    if (sw) {
      const float td = bd[t];
      const int ti = bi[t];
      bd[t] = cd;
      bi[t] = ci;
      cd = td;
      ci = ti;
      carrying = true;
    }
  }
}

// One staged tile against the Q queries of this thread, k = 1: a running
// minimum per query, and in `bc` the packed position of the first reference
// of the last group that lowered it (the group that holds the first
// reference at the final minimum; pair_first_at() finds it there).
template <int D, int Q>
__device__ __forceinline__ void pair_consume_min(const float4* stage,
                                                 int padded, int base,
                                                 const float (&qv)[Q][D],
                                                 float (&bd)[Q], int (&bc)[Q]) {
  for (int j = 0; j < padded; j += PAIR_GROUP) {
    float prev[Q];
#pragma unroll
    for (int a = 0; a < Q; ++a) prev[a] = bd[a];
#pragma unroll
    for (int u = 0; u < PAIR_GROUP; ++u) {
      const float4 r = stage[j + u];
#pragma unroll
      for (int a = 0; a < Q; ++a) bd[a] = fminf(bd[a], pair_dist2<D>(qv[a], r));
    }
#pragma unroll
    for (int a = 0; a < Q; ++a)
      if (bd[a] < prev[a]) bc[a] = base + j;
  }
}

// The original index of the first packed reference in [c, c + PAIR_GROUP)
// below `end` whose distance to `qv` equals `best` bit for bit; -1 if c < 0.
template <int D>
__device__ __forceinline__ int pair_first_at(const float4* __restrict__ ref4,
                                             int c, int end,
                                             const float (&qv)[D], float best) {
  int found = -1;
  if (c < 0) return found;
#pragma unroll 4
  for (int u = PAIR_GROUP - 1; u >= 0; --u) {
    if (c + u < end) {
      const float4 r = ref4[(size_t)c + u];
      if (pair_dist2<D>(qv, r) == best) found = __float_as_int(r.w);
    }
  }
  return found;
}

// One staged tile against the Q queries of this thread, k > 1: groups of
// PAIR_U references; the sorted insertion runs only for a group in which
// some pair beats the worst entry of its list and passes its query's gate
// d2 <= gate[a] (the sweep's r^2; in the brute-force search a bound on the
// k-th distance known beforehand, or +inf).
#define PAIR_U 4  // references per group of the k > 1 and moment loops
template <int D, int K, int Q>
__device__ __forceinline__ void pair_consume_topk(const float4* stage,
                                                  int padded,
                                                  const float (&gate)[Q],
                                                  const float (&qv)[Q][D],
                                                  float (&bd)[Q][K],
                                                  int (&bi)[Q][K]) {
  for (int j = 0; j < padded; j += PAIR_U) {
    float4 r[PAIR_U];
    float d[Q][PAIR_U];
    bool hit = false;
#pragma unroll
    for (int u = 0; u < PAIR_U; ++u) r[u] = stage[j + u];
#pragma unroll
    for (int a = 0; a < Q; ++a) {
      float m = PAIR_INF;
#pragma unroll
      for (int u = 0; u < PAIR_U; ++u) {
        d[a][u] = pair_dist2<D>(qv[a], r[u]);
        m = fminf(m, d[a][u]);
      }
      hit = hit || (m < bd[a][K - 1] && m <= gate[a]);
    }
    if (hit) {  // rare: a group with a candidate for some list
#pragma unroll
      for (int a = 0; a < Q; ++a) {
#pragma unroll
        for (int u = 0; u < PAIR_U; ++u) {
          if (d[a][u] <= gate[a] && d[a][u] < bd[a][K - 1])
            pair_list_insert<K>(bd[a], bi[a], d[a][u], __float_as_int(r[u].w));
        }
      }
    }
  }
}

// One more reference inside the radius of query `q`: its count, the sum of
// d = r - q and the upper triangle of the sum of d d^T (1, x, y, z, xx, yy,
// zz, xy, xz, yz at D = 3; 1, x, y, xx, yy, xy at D = 2).  |d| <= radius, so
// the sums carry no cancellation however far the cloud lies from the origin.
// Products and sums may contract into FMAs here: these sums are compared
// with the plain version's to rounding, not bit for bit.
template <int D>
__device__ __forceinline__ void pair_add_moments(
    float (&acc)[1 + D + D * (D + 1) / 2], const float (&q)[D],
    const float4 r) {
  float d[D];
  d[0] = __fsub_rn(r.x, q[0]);
  d[1] = __fsub_rn(r.y, q[1]);
  if (D == 3) d[D - 1] = __fsub_rn(r.z, q[D - 1]);
  acc[0] += 1.0f;
#pragma unroll
  for (int a = 0; a < D; ++a) {
    acc[1 + a] += d[a];
    acc[1 + D + a] += d[a] * d[a];
  }
  int t = 1 + 2 * D;
#pragma unroll
  for (int a = 0; a < D; ++a) {
#pragma unroll
    for (int c = a + 1; c < D; ++c) {
      acc[t] += d[a] * d[c];
      ++t;
    }
  }
}

// One staged tile against the Q queries of this thread, radius moments:
// groups of PAIR_U references; the sums run only for a group in which some
// pair of this thread passes d2 <= r2, and inside it only for those pairs.
// One staged tile against the Q queries of this thread, radius moments.
// S lanes (1, 2 or 4 neighbours in a warp) hold the same queries and share
// the tile: lane `sub` of them takes every S-th reference, PAIR_U at a time,
// and adds the moments of each pair with d2 <= r2; the caller sums the S
// partial results.  (Few of the pairs pass, and the lanes of a warp pass at
// different references, so a test of the whole group before the sums only
// added instructions; see PERF.md.)
template <int D, int Q, int S>
__device__ __forceinline__ void pair_consume_moments(
    const float4* stage, int padded, int sub, float r2,
    const float (&qv)[Q][D], float (&acc)[Q][1 + D + D * (D + 1) / 2]) {
  static_assert(S * PAIR_U <= PAIR_GROUP, "a step must fit the padding");
  for (int j = 0; j < padded; j += PAIR_U * S) {
    float4 r[PAIR_U];
#pragma unroll
    for (int u = 0; u < PAIR_U; ++u) r[u] = stage[j + u * S + sub];
#pragma unroll
    for (int a = 0; a < Q; ++a) {
      float d[PAIR_U];
#pragma unroll
      for (int u = 0; u < PAIR_U; ++u) d[u] = pair_dist2<D>(qv[a], r[u]);
#pragma unroll
      for (int u = 0; u < PAIR_U; ++u) {
        if (d[u] <= r2) pair_add_moments<D>(acc[a], qv[a], r[u]);
      }
    }
  }
}

// The packed references [r0, r1) streamed past the block: tiles of TILE
// references through the two-deep `ring` (PAIR_STAGES * TILE float4 of
// shared memory), one block barrier per tile, the next tile in flight while
// `consume(tile, padded, base)` works on this one (`padded`: the tile's
// length rounded up to PAIR_GROUP, the excess filled with the padding
// reference; `base`: the packed position of its first reference).  Every
// thread of the block calls this with the same range.
template <int TILE, class Consume>
__device__ __forceinline__ void pair_stream_range(
    float4* ring, const float4* __restrict__ ref4, int r0, int r1,
    Consume consume) {
  __syncthreads();  // the ring is free (an earlier pass is done with it)
  if (r0 < r1) pair_stage_async(ring, ref4, r0, min(TILE, r1 - r0));
  int stage = 0;
  for (int base = r0; base < r1; base += TILE) {
    const int cnt = min(TILE, r1 - base);
    pair_cp_async_wait_all();
    __syncthreads();  // this tile landed; the other stage is consumed
    const int nxt = base + TILE;
    if (nxt < r1)
      pair_stage_async(ring + (stage ^ 1) * TILE, ref4, nxt,
                       min(TILE, r1 - nxt));
    consume(ring + stage * TILE, (cnt + PAIR_GROUP - 1) & ~(PAIR_GROUP - 1),
            base);
    stage ^= 1;
  }
}

// The Q queries of this thread against the packed references [r0, r1),
// ranked into their lists.  r0 must be a multiple of PAIR_GROUP away from
// the start the k = 1 groups are counted from.  At K == 1 `bi` holds the
// group's packed position (see pair_consume_min) and `gate` is not read:
// the gate is the caller's, on the final minimum.
template <int D, int K, int Q, int TILE>
__device__ __forceinline__ void pair_search_range(
    float4* ring, const float4* __restrict__ ref4, int r0, int r1,
    const float (&gate)[Q], const float (&qv)[Q][D], float (&bd)[Q][K],
    int (&bi)[Q][K]) {
  pair_stream_range<TILE>(
      ring, ref4, r0, r1, [&](const float4* cur, int padded, int base) {
        if constexpr (K == 1) {
          float b1[Q];
          int c1[Q];
#pragma unroll
          for (int a = 0; a < Q; ++a) {
            b1[a] = bd[a][0];
            c1[a] = bi[a][0];
          }
          pair_consume_min<D, Q>(cur, padded, base, qv, b1, c1);
#pragma unroll
          for (int a = 0; a < Q; ++a) {
            bd[a][0] = b1[a];
            bi[a][0] = c1[a];
          }
        } else {
          pair_consume_topk<D, K, Q>(cur, padded, gate, qv, bd, bi);
        }
      });
}

// The Q queries of this thread against its share (`sub` of S lanes) of the
// packed references [r0, r1), summed into their radius moments.
template <int D, int Q, int S, int TILE>
__device__ __forceinline__ void pair_moments_range(
    float4* ring, const float4* __restrict__ ref4, int r0, int r1, int sub,
    float r2, const float (&qv)[Q][D],
    float (&acc)[Q][1 + D + D * (D + 1) / 2]) {
  pair_stream_range<TILE>(
      ring, ref4, r0, r1, [&](const float4* cur, int padded, int) {
        pair_consume_moments<D, Q, S>(cur, padded, sub, r2, qv, acc);
      });
}

// Position of the first of the x-sorted packed references [0, n) whose x is
// not below `v` (`right` false: what searchsorted returns) or above `v`
// (`right` true).  A binary search by one thread.
__device__ __forceinline__ int pair_bound_x(const float4* __restrict__ ref4,
                                            int n, float v, bool right) {
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const float x = ref4[mid].x;
    if (right ? (x <= v) : (x < v))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The lists of the blocks of a cluster merged into block 0's registers.
// Every block of the cluster calls this once, after its search; `smem` is
// the block's shared memory (the ring, free by now), at least
// K * Q * PAIR_THREADS * 8 bytes.  Block s > 0 leaves its lists there,
// block 0 reads them through distributed shared memory in ascending s and
// inserts with strict `<`: the blocks' ranges ascend with s, so an entry of
// a later range enters only with a strictly smaller distance, and the tie
// rule holds across range borders.
template <int K, int Q>
__device__ __forceinline__ void pair_merge_cluster(
    cooperative_groups::cluster_group& cluster, unsigned char* smem,
    float (&bd)[Q][K], int (&bi)[Q][K]) {
  constexpr int SLOTS = PAIR_THREADS * Q;
  float* part_d = reinterpret_cast<float*>(smem);          // [K][SLOTS]
  int* part_i = reinterpret_cast<int*>(smem) + K * SLOTS;  // [K][SLOTS]
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  __syncthreads();  // every thread of the block is done with the ring
  if (rank != 0) {
#pragma unroll
    for (int a = 0; a < Q; ++a) {
#pragma unroll
      for (int t = 0; t < K; ++t) {
        part_d[t * SLOTS + a * PAIR_THREADS + tid] = bd[a][t];
        part_i[t * SLOTS + a * PAIR_THREADS + tid] = bi[a][t];
      }
    }
  }
  cluster.sync();
  if (rank == 0) {
    for (int s = 1; s < S; ++s) {
      const float* rd = cluster.map_shared_rank(part_d, s);
      const int* ri = cluster.map_shared_rank(part_i, s);
#pragma unroll
      for (int a = 0; a < Q; ++a) {
#pragma unroll 1
        for (int t = 0; t < K; ++t) {
          const float cd = rd[t * SLOTS + a * PAIR_THREADS + tid];
          const int ci = ri[t * SLOTS + a * PAIR_THREADS + tid];
          if (cd < bd[a][K - 1]) pair_list_insert<K>(bd[a], bi[a], cd, ci);
        }
      }
    }
  }
  cluster.sync();  // the lists stay alive until block 0 has read them
}
