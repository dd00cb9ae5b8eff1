// Shared pieces of the kernels.
//
// Two generations live here.  The PACKED PAIR LOOP (second half of this
// file) is what knn_brute.cu and sweep_knn.cu are built from; the plain
// staging and distance of the first half still serve radius_pca.cu.
//
// Schedule common to the two sorted sweeps (sweep_knn.cu, radius_pca.cu):
// queries and references are sorted by x.  A block owns consecutive sorted
// queries and a contiguous window [start[b], end[b]) of the sorted
// references that the wrapper computed for it (every reference within the
// radius of any of the block's queries lies inside).  The block streams its
// window through shared memory; every thread reads every staged reference
// (a broadcast read, no bank conflict).  knn_brute.cu is the same loop with
// the whole packed reference array as its window and no radius gate.
//
// What bounds the pair loop on an H100, and what the packed form does about
// it.  The distance is 3 subtractions, 3 products and 2 sums, each rounded
// on its own (see pair_dist2), so a pair costs 8 arithmetic instructions
// plus whatever ranks it; a scheduler dispatches one instruction per clock for
// a warp, so 132 SMs x 4 schedulers x 32 lanes x clock / (instructions per
// pair) is the ceiling.  The first form of the loop spent about 14 dispatch
// slots per pair (three 32-bit shared-memory loads, a loop counter, a
// compare and a branch per pair) and stalled at two block barriers per 256
// references.  The packed form
//   * reads a reference as ONE 128-bit shared-memory load (x, y, z and the
//     bits of its original index in the fourth lane) and uses it for Q
//     queries held in the registers of one thread, so loads and loop
//     bookkeeping are shared by Q pairs;
//   * stages tiles of references (16 bytes each) with cp.async into a two-deep
//     ring: the next tile arrives while this one is consumed, one block
//     barrier per tile;
//   * pads a partial tile in shared memory up to PAIR_GROUP with a
//     reference at x = +inf (its distance is +inf and ranks nowhere), so the
//     inner loops are unrolled groups without a bound check;
//   * ranks a group of pairs at once: at k = 1 a running minimum (one FMNMX
//     per pair) and a note of the last group that improved it, the index
//     being recovered from that group afterwards; at k > 1 the minimum of a
//     group against the list's worst entry and the query's gate (the
//     sweep's r^2, or a bound on the k-th distance known beforehand), and
//     the sorted insertion only for a group that has a candidate.
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

#define SWEEP_TR 256  // references staged per shared-memory tile (radius_pca)

// Squared distance, subtract first, every product and sum rounded to f32 on
// its own: the intrinsics stop nvcc from contracting `s + d*d` into an FMA.
// Eager PyTorch (the plain version) and XLA on the CPU do not contract, so
// with this form kernel and plain version agree bit for bit and a pair
// within an ulp of r^2 falls on the same side of the gate in both.
template <int D>
__device__ __forceinline__ float sweep_dist2(const float* __restrict__ q,
                                             const float* __restrict__ r) {
  float d0 = __fsub_rn(r[0], q[0]);
  float s = __fmul_rn(d0, d0);
#pragma unroll
  for (int a = 1; a < D; ++a) {
    float d = __fsub_rn(r[a], q[a]);
    s = __fadd_rn(s, __fmul_rn(d, d));
  }
  return s;
}

// Cooperative copy of `cnt` references (row-major [cnt, D], contiguous in
// global memory, so the copy is coalesced) into the shared tile.
template <int D>
__device__ __forceinline__ void sweep_stage(float* tile,
                                            const float* __restrict__ ref,
                                            int base, int cnt) {
  const float* src = ref + (size_t)base * D;
  for (int t = threadIdx.x; t < cnt * D; t += blockDim.x) tile[t] = src[t];
}

// ---------------------------------------------------------------------------
// the packed pair loop
// ---------------------------------------------------------------------------

#define PAIR_STAGES 2   // depth of the ring of staged tiles
#define PAIR_GROUP 16   // a staged tile is padded to a multiple of this
#define PAIR_THREADS 128  // threads per block of the kernels built on this

#define PAIR_INF __int_as_float(0x7f800000)

// The same arithmetic as sweep_dist2, on a packed reference.
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
#define PAIR_U 4  // references per group of the k > 1 loop
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

// The Q queries of this thread against the packed references [r0, r1):
// tiles of TILE references through the two-deep `ring` (PAIR_STAGES * TILE
// float4 of shared memory), one block barrier per tile, the next tile in
// flight while this one is consumed.  r0 must be a multiple of PAIR_GROUP
// away from the start the k = 1 groups are counted from.  At K == 1 `bi`
// holds the group's packed position (see pair_consume_min) and `gate` is
// not read: the gate is the caller's, on the final minimum.
template <int D, int K, int Q, int TILE>
__device__ __forceinline__ void pair_search_range(
    float4* ring, const float4* __restrict__ ref4, int r0, int r1,
    const float (&gate)[Q], const float (&qv)[Q][D], float (&bd)[Q][K],
    int (&bi)[Q][K]) {
  __syncthreads();  // the ring is free (an earlier search is done with it)
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
    const float4* cur = ring + stage * TILE;
    const int padded = (cnt + PAIR_GROUP - 1) & ~(PAIR_GROUP - 1);
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
    stage ^= 1;
  }
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
