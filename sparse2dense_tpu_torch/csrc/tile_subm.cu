// Fused tile submanifold 3x3x3 conv over z-chunked 4x4 BEV tiles, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel sparse2dense_tpu/ops/pallas/tile_block_kernel.py
// _tile_kernel (:156), called by tile_subm_pallas (:343), without its nine
// export arrays.
//
// Contract (ops/tile_kernel.py tile_subm_plain). State is z-major, (tz, T1p,
// 16 C): one row per (z, tile) plane of a (tz, 4, 4) chunk tile, cell =
// y4 * 4 + x4. For tile t, plane z and cell (y4, x4):
//     acc[co] = sum over taps k = (kz, ky, kx) and ci of
//               src(t; z + kz - 1, y4 + ky - 1, x4 + kx - 1)[ci] * w[k][ci][co]
//     y = acc * scale16 + shift16 (+ residual); ReLU if relu; * mask16
// stored in the state's type. A halo cell (z', y', x') with z' in -1..tz and
// y', x' in -1..4 lies in tile offset (dz, dy, dx) (-1 below the chunk or
// tile, +1 above it, else 0); at (0, 0, 0) it is tile t's own cell, else cell
// (z' mod tz, y' mod 4, x' mod 4) of tile tgt[t / 128][dir_row(dz, dy, dx)]
// [t % 128]. A target outside [0, T1p) (SENTINEL: absent, or dropped by the
// plan's windows) reads zero, so every tap the plan dropped stays dropped, as
// in the TPU kernel. Weights come in the state's type (the TPU kernel rounds
// them to it); products and sums are float32. mask16 is a cell mask repeated
// over the output channels (tile_kernel.expand_mask).
//
// Design. The TPU kernel fetches nine rank windows by DMA, selects neighbour
// cells with one-hot MXU matmuls, convolves a 36-cell halo plane with a
// (36 C, 48 Co) matrix and emits export arrays for the next conv: layout
// workarounds for a chip without a fast gather. Here the unit of work is one
// live (z, tile) plane, one with an unmasked cell: at conv1 of the flagship
// frame ~1 (z, tile) row in 6 is live, at conv2 ~1 in 4. Planes are taken
// in column order (tile-major, z inside: i = t * tz + z), so that the live
// z-neighbours of a tile column come together. The rows of dead planes are
// written as zeros (their every cell is masked out): the whole-output write
// that bounds the kernel. No result depends on the order of blocks, and no
// atomics touch the output.
// - bfloat16 state (the flagship): the wgmma core of csrc/plane_subm.cu
//   (wgmma.cuh). A group of 4 live planes is the 64 rows of a warpgroup's
//   m64nNk16 (a warp's 16 rows are its plane's cells). Its halo is gathered
//   by z layer: a plane reads the 6 x 6 cells of 3 layers (z - 1, z, z + 1 of
//   its column), planes of one column that are z-neighbours share layers,
//   and each distinct (tile, layer) of the group is gathered once (at most
//   12 layers, 432 rows) by cp.async, 16 B a thread, zero-filled where the
//   source is absent. A comes by ldmatrix from the layers of the warp's
//   plane, B is the tap's weights in the host-built no-swizzle K-major
//   layout (plane_kernel.wgmma_weights). A tap is skipped when none of the
//   group's rows has a source in a present plane. Blocks are persistent, as
//   many as fit the SMs. Weights, by width (as in B2):
//   * C <= 32 (conv1, conv2): all 27 taps stay in shared memory for the
//     block's life (14 / 55 KB, one bulk copy). Four warpgroups a block each
//     claim chunks of 256 planes from a counter, scan them (scan_chunk, as
//     the compaction kernel does: a half-warp reads a plane's mask, so a
//     warp's loads cover whole rows, and the dead rows are zeroed), list the
//     live ones in shared memory and walk them in groups of 4
//     with a halo of their own: one warpgroup streams a chunk's mask and
//     zeros while another gathers or multiplies, and the next group's
//     sources and epilogue operands load while a warpgroup multiplies.
//   * C = 64 and 128: a compaction kernel (tile_live) first lists the live
//     planes and zeroes the others; the conv then takes the list in groups,
//     its taps streaming through a ring of shared slots, filled by a producer
//     warp with bulk copies and released by each consumer warp once its
//     wgmma is done; two teams share each tap (two groups at C = 64; at
//     C = 128 one group, each warpgroup with half of the output channels).
//   Variants measured on the H100 on copies of this source
//   (tools/bench_tile_subm.py; times in PERF.md) and left out: the planes in
//   z-major order with a 108-row halo a plane (B2's unit, no sharing:
//   slower at every conv, by 18% at conv2); the compaction as a kernel of
//   its own before the conv at C <= 32 (slower by 5-20%); taps in batches of
//   8 / 4 a wgmma group, two accumulators, two blocks an SM at C = 16
//   (registers capped): none faster.
// - float32 state (the agreement runs): the compaction kernel, then
//   CUDA-core FMAs, a thread per (plane, cell) row and 16 output channels.
// Halo rows are padded by 16 B so the lanes of an ldmatrix spread over the
// banks.
//
// Bound on an H100 (3.35 TB/s, 989 TFLOP/s bf16): bytes. The contract
// writes every (z, tile) row of the output, 0.30 GB at conv1 and 0.37 GB at
// conv2 of the flagship frame (~0.1 ms), while the live planes' active
// (cell, tap) pairs need a few GFLOP (a few us). Beyond the bound this
// design reads a 32-byte sector of the mask a cell to find the live planes
// (all of the mask at C = 16), gathers each live layer's halo from L2 once
// per group that reads it, and multiplies whole 64-row tiles however few of
// their cells are active. A copy with the scan alone keeps 45% (conv1) and
// 35% (conv2) of the time, one without the wgmma 76% and 71% (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;   // compaction and float32 kernel
constexpr int kWarps = kThreads / 32;
constexpr int kBlk = 128;       // tiles per plan block
constexpr int kHalo = 108;      // 3 z planes x 6 x 6 halo cells
constexpr int kSmemMax = 232448;

// halo cell h of plane q = z * t1p + t -> source (plane row * 16 + cell) in
// the state, -1 = zero
__device__ __forceinline__ int halo_source(const int* __restrict__ tgt, int q, int h,
                                           int t1p, int tz) {
  const int z = q / t1p, t = q % t1p;
  const int zz = z + h / 36 - 1, yy = (h / 6) % 6 - 1, xx = h % 6 - 1;
  const int dzb = zz < 0 ? -1 : (zz >= tz ? 1 : 0);
  const int dyb = yy < 0 ? -1 : (yy > 3 ? 1 : 0);
  const int dxb = xx < 0 ? -1 : (xx > 3 ? 1 : 0);
  const int cell = ((yy + 4) & 3) * 4 + ((xx + 4) & 3);
  int r = t;
  if (dzb != 0 || dyb != 0 || dxb != 0) {
    const int dir = ((dzb + 1) * 3 + dyb + 1) * 3 + dxb + 1;
    r = tgt[((t / kBlk) * 32 + dir) * kBlk + t % kBlk];
  }
  return (r >= 0 && r < t1p) ? ((zz - dzb * tz) * t1p + r) * 16 + cell : -1;
}

// halo index of output cell `cell` under tap (kz, ky, kx)
__device__ __forceinline__ int halo_of(int cell, int kz, int ky, int kx) {
  return kz * 36 + (cell / 4 + ky) * 6 + cell % 4 + kx;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// One chunk of kChunk planes of the column order (i = t * tz + z, plane q =
// z * t1p + t, n = tz * t1p planes in all) from i0, scanned by the NT
// threads tid = 0 .. NT - 1 that `sync` holds together: the live planes go
// into live[] in order and the output rows of the others are written as
// zeros. The mask is read a half-warp a plane, a lane a cell, so each load of
// a warp covers two whole rows. Scratch: dead[kChunk], wcount[2 * NT / 32],
// flag[kChunk]. Returns the number of live planes.
constexpr int kChunk = 256;
template <typename T, int CO, int NT, typename Sync>
__device__ __forceinline__ int scan_chunk(const T* __restrict__ mask, T* __restrict__ out,
                                          int t1p, int tz, int i0, int tid, int* live,
                                          int* dead, int* wcount, unsigned char* flag,
                                          Sync sync) {
  constexpr int kW = NT / 32, kP = kChunk / NT;   // warps, planes a thread places
  const int lane = tid % 32, warp = tid / 32, n = tz * t1p;
  auto plane_of = [&](int i) { return i < n ? (i % tz) * t1p + i / tz : -1; };
  bool cell_on[16 * kP];
#pragma unroll
  for (int it = 0; it < 16 * kP; ++it) {   // planes it * NT / 16 + tid / 16
    const int q = plane_of(i0 + it * (NT / 16) + tid / 16);
    cell_on[it] = q >= 0 && to_float(mask[(static_cast<size_t>(q) * 16 + tid % 16) * CO]) != 0.f;
  }
#pragma unroll
  for (int it = 0; it < 16 * kP; ++it) {
    const unsigned b = __ballot_sync(0xffffffffu, cell_on[it]);
    if (lane == 0) {
      flag[it * (NT / 16) + 2 * warp] = (b & 0xffffu) != 0;
      flag[it * (NT / 16) + 2 * warp + 1] = (b >> 16) != 0;
    }
  }
  sync();
  // thread tid places planes kP tid .. kP tid + kP - 1, in order
  int q[kP];
  bool on[kP], off[kP];
  int nl = 0, nd = 0;
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    q[p] = plane_of(i0 + kP * tid + p);
    on[p] = flag[kP * tid + p];
    off[p] = q[p] >= 0 && !on[p];
    nl += on[p];
    nd += off[p];
  }
  int bl = -nl, bd = -nd;   // exclusive of this thread's planes
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {   // inclusive warp scans
    const int l = __shfl_up_sync(0xffffffffu, nl, d), e = __shfl_up_sync(0xffffffffu, nd, d);
    if (lane >= d) {
      nl += l;
      nd += e;
    }
  }
  if (lane == 31) {
    wcount[warp] = nl;
    wcount[kW + warp] = nd;
  }
  sync();
  int total = 0, total_dead = 0;
  bl += nl;
  bd += nd;
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    bl += w < warp ? wcount[w] : 0;
    bd += w < warp ? wcount[kW + w] : 0;
    total += wcount[w];
    total_dead += wcount[kW + w];
  }
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    if (on[p]) live[bl++] = q[p];
    if (off[p]) dead[bd++] = q[p];
  }
  sync();
  constexpr int kVec = 16 * CO * static_cast<int>(sizeof(T)) / 16;   // 16-byte pieces a row
  uint4* o = reinterpret_cast<uint4*>(out);
  for (int j = tid; j < total_dead * kVec; j += NT)
    o[static_cast<size_t>(dead[j / kVec]) * kVec + j % kVec] = make_uint4(0, 0, 0, 0);
  return total;
}

// Compaction: list[count++] = q for every live plane, a block a chunk of the
// column order; the output rows of the other planes are set to zero here.
template <typename T, int CO>
__global__ void __launch_bounds__(kThreads)
tile_live(const T* __restrict__ mask, T* __restrict__ out, int t1p, int tz,
          int* __restrict__ count, int* __restrict__ list) {
  __shared__ int live[kChunk], dead[kChunk], wcount[2 * kWarps];
  __shared__ unsigned char flag[kChunk];
  __shared__ int block_base;
  const int tid = threadIdx.x;
  const int nl = scan_chunk<T, CO, kThreads>(mask, out, t1p, tz, blockIdx.x * kChunk, tid, live,
                                             dead, wcount, flag, [] { __syncthreads(); });
  if (tid == 0) block_base = nl > 0 ? atomicAdd(count, nl) : 0;
  __syncthreads();
  if (tid < nl) list[block_base + tid] = live[tid];
}

// qs[i] = list[i0 + i] for the P planes of the block's next turn, or -1 past
// the list's end (a block-wide barrier before and after)
template <int P>
__device__ __forceinline__ void next_planes(const int* __restrict__ list, int i0, int n,
                                            int* qs) {
  __syncthreads();  // the previous turn's readers are done
  if (threadIdx.x < P) qs[threadIdx.x] = i0 + threadIdx.x < n ? list[i0 + threadIdx.x] : -1;
  __syncthreads();
}

// src[i] for the P planes of the block: halo sources, -1 past the list's end
template <int P>
__device__ __forceinline__ void halo_sources(const int* __restrict__ tgt, int t1p, int tz,
                                             const int* qs, int* src) {
  for (int i = threadIdx.x; i < P * kHalo; i += kThreads) {
    const int q = qs[i / kHalo];
    src[i] = q >= 0 ? halo_source(tgt, q, i % kHalo, t1p, tz) : -1;
  }
}

// ---------------------------------------------------------------------------
// bfloat16 state: wgmma over groups of 4 live planes, halos by z layer
// ---------------------------------------------------------------------------

constexpr int kGroup = 4;             // planes a group: the 64 rows of a wgmma
constexpr int kLayer = 36;            // 6 x 6 halo cells of one z layer
constexpr int kLayers = 3 * kGroup;   // z layers a group reads, at most
// a warpgroup's scan area: live and dead lists, counts a warp, flags, claim
constexpr int kScanInts = 2 * kChunk + 8 + kChunk / 4 + 8;

template <int C, int CO>
struct WgShape {
  static constexpr bool kResident = C <= 32;       // all 27 taps stay in shared memory
  static constexpr int kWG = kResident ? 4 : 2;    // consumer warpgroups a block
  // streamed weights: one more warp, the producer, keeps the ring full
  static constexpr int kThreads = kWG * 128 + (kResident ? 0 : 32);
  static constexpr int kSplit = C == 128 ? 2 : 1;  // warpgroups sharing a group (CO split)
  static constexpr int kN = CO / kSplit;           // output channels a warpgroup
  static constexpr int kTeams = kWG / kSplit;      // groups a block works on at once
  // planes a block takes a turn: chunks it scans, or groups of the list
  static constexpr int kUnit = kResident ? kChunk * kWG : kGroup * kTeams;
  static constexpr int kNA = 2;                    // A fragments of taps in flight
  static constexpr int kRing = C == 64 ? 8 : 3;    // streamed taps in flight
  static constexpr int kBars = kResident ? 1 : 2 * kRing;   // full, then empty
  static constexpr int kStride = C + 8;            // halo row, bf16 (16 B pad: banks)
  static constexpr int kTapElems = C * CO;
  static constexpr uint32_t kTapBytes = 2 * kTapElems;
  static constexpr int kWElems = (kResident ? 27 : kRing) * kTapElems;
  static constexpr int kHaloElems = kLayers * kLayer * kStride;   // a team's halo
  static constexpr int kTeamThreads = 128 * kSplit;
  static constexpr int kRows = (kLayers * kLayer + kTeamThreads - 1) / kTeamThreads;
  // mbarriers [0, 256), tap masks [256, 320), layer cell table [512, 800);
  // after weights and halos, a scan area a warpgroup (resident weights)
  static constexpr size_t kHead = 1024;
  static constexpr size_t kSmem = kHead + 2 * (size_t(kWElems) + kTeams * kHaloElems) +
                                  (kResident ? 4 * kWG * kScanInts : 0);
  static_assert(kSmem <= kSmemMax, "shared memory");
  static_assert(8 * kBars <= 256 && 4 * 4 * kWG <= 64, "head");
  static_assert(C % 16 == 0 && (kN == 16 || kN == 32 || kN == 64), "shape");
};

// 9-bit mask of the (ky, kx) taps that read cell h of a 6 x 6 halo layer for
// some cell of the 4 x 4 tile
__device__ __forceinline__ int layer_taps(int h) {
  const int yy = h / 6, xx = h % 6;
  int bits = 0;
  for (int ky = max(0, yy - 3); ky <= min(2, yy); ++ky)
    for (int kx = max(0, xx - 3); kx <= min(2, xx); ++kx) bits |= 1 << (ky * 3 + kx);
  return bits;
}

// A group's halo, as each of its warps sees it. Lane l < 12 of every warp
// holds candidate layer l: layer z + l % 3 - 1 of the column of the group's
// plane l / 3 (an entry past the list's end repeats the first plane); equal
// candidates share a slot of 36 halo rows, numbered in order of first
// appearance.
struct GroupHalo {
  int key;      // lane s < n_slots: slot s's layer, t * (tz + 2) + z' + 1
  int kz_set;   // lane s < n_slots: the kz of the taps that read slot s (3 bits)
  int n_slots;  // distinct layers
  int slot[3];  // this warp's plane: slot of its layer kz = 0, 1, 2
  int q;        // this warp's plane, -1 past the list's end
};

__device__ __forceinline__ GroupHalo group_halo(const int* __restrict__ list, int e0, int n,
                                                int t1p, int tz, int warp, int lane) {
  GroupHalo h;
  const int p = min(lane / 3, kGroup - 1);
  const int e = e0 + p < n ? list[e0 + p] : list[e0];
  const int key = lane < kLayers ? (e % t1p) * (tz + 2) + e / t1p + lane % 3 : -1 - lane;
  int first = lane;
#pragma unroll
  for (int j = 0; j < kLayers; ++j) {
    const int kj = __shfl_sync(0xffffffffu, key, j);
    if (kj == key && j < first) first = j;
  }
  const unsigned fresh = __ballot_sync(0xffffffffu, lane < kLayers && first == lane);
  const int slot_of = __popc(fresh & ((1u << first) - 1u));
  h.n_slots = __popc(fresh);
  int owner = 0;
  h.kz_set = 0;
#pragma unroll
  for (int j = 0; j < kLayers; ++j) {
    const int sj = __shfl_sync(0xffffffffu, slot_of, j);
    if (sj == lane) {
      h.kz_set |= 1 << (j % 3);
      if ((fresh >> j) & 1) owner = j;
    }
  }
  h.key = __shfl_sync(0xffffffffu, key, owner);
#pragma unroll
  for (int kz = 0; kz < 3; ++kz) h.slot[kz] = __shfl_sync(0xffffffffu, slot_of, 3 * warp + kz);
  h.q = e0 + warp < n ? __shfl_sync(0xffffffffu, e, 3 * warp) : -1;
  return h;
}

// wb: weights in the B layout of wgmma (plane_kernel.wgmma_weights): per tap
// (C / 8, CO / 8, 8 co, 8 ci) bf16. count: zero at launch; with resident
// weights the counter of claimed chunks, else with list the compaction's
// output.
template <int C, int CO>
__global__ void __launch_bounds__(WgShape<C, CO>::kThreads)
tile_subm_wgmma(const __nv_bfloat16* __restrict__ state, const int* __restrict__ tgt,
                const __nv_bfloat16* __restrict__ wb, const float* __restrict__ scale,
                const float* __restrict__ shift, const __nv_bfloat16* __restrict__ mask,
                const __nv_bfloat16* __restrict__ resid, __nv_bfloat16* __restrict__ out,
                const int* __restrict__ list, int* __restrict__ count, int t1p, int tz,
                int relu) {
  using S = WgShape<C, CO>;
  constexpr int N = S::kN;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem + S::kHead);
  const int tid = threadIdx.x, wg = tid / 128, wtid = tid % 128;
  const int warp = wtid / 32, lane = tid % 32;
  const int team = wg / S::kSplit, n0 = (wg % S::kSplit) * N;   // group slot, columns
  const int ttid = tid % S::kTeamThreads, twarp = ttid / 32;      // in the team
  const uint32_t bar0 = smem_addr(smem);
  __nv_bfloat16* halo = wsm + S::kWElems + team * S::kHaloElems;
  int* tw = reinterpret_cast<int*>(smem + 256) + team * 4 * S::kSplit;  // a word a team warp
  // cell h of a halo layer: its (dy, dx) direction part and cell, and the
  // (ky, kx) taps that read it
  int* linfo = reinterpret_cast<int*>(smem + 512);
  int* ltaps = linfo + kLayer;
  for (int h = tid; h < kLayer; h += S::kThreads) {
    const int yy = h / 6 - 1, xx = h % 6 - 1;
    const int dyb = yy < 0 ? -1 : (yy > 3 ? 1 : 0), dxb = xx < 0 ? -1 : (xx > 3 ? 1 : 0);
    linfo[h] = ((dyb + 1) * 3 + dxb + 1) | ((((yy + 4) & 3) * 4 + ((xx + 4) & 3)) << 8);
    ltaps[h] = layer_taps(h);
  }

  if (tid == 0) {  // weights: all 27 taps at once, or the ring's barriers
    for (int s = 0; s < S::kBars; ++s)
      mbar_init(bar0 + 8 * s, S::kResident || s < S::kRing ? 1 : 4 * S::kWG);
    fence_barrier_init();
    if (S::kResident) {
      mbar_expect_tx(bar0, 27 * S::kTapBytes);
      bulk_load(smem_addr(wsm), wb, 27 * S::kTapBytes, bar0);
    }
  }
  __syncthreads();

  // A team thread owns halo rows ttid + kTeamThreads j of a group (slot
  // r / 36, layer cell r % 36). The sources of group g's rows (state row *
  // 16 + cell, -1 for none) and the taps they feed:
  auto sources = [&](const int* lst, int n, int g, GroupHalo& gh, int (&src)[S::kRows],
                     int& bits) {
    gh = group_halo(lst, g * kGroup, n, t1p, tz, warp, lane);
    bits = 0;
#pragma unroll
    for (int j = 0; j < S::kRows; ++j) {
      const int r = ttid + S::kTeamThreads * j, s = min(r / kLayer, kLayers - 1);
      const int key = __shfl_sync(0xffffffffu, gh.key, s);
      const int kzs = __shfl_sync(0xffffffffu, gh.kz_set, s);
      src[j] = -1;
      if (s < gh.n_slots && r < kLayers * kLayer) {
        const int t = key / (tz + 2), zz = key % (tz + 2) - 1;
        const int info = linfo[r % kLayer];
        const int dzb = zz < 0 ? -1 : (zz >= tz ? 1 : 0), dir = (dzb + 1) * 9 + (info & 255);
        const int rt = dir == 13 ? t : tgt[((t / kBlk) * 32 + dir) * kBlk + t % kBlk];
        if (rt >= 0 && rt < t1p) {
          src[j] = ((zz - dzb * tz) * t1p + rt) * 16 + (info >> 8);
          const int lt = ltaps[r % kLayer];
#pragma unroll
          for (int kz = 0; kz < 3; ++kz)
            if ((kzs >> kz) & 1) bits |= lt << (9 * kz);
        }
      }
    }
    bits = __reduce_or_sync(0xffffffffu, bits);
  };
  // issue the halo copies of a group and publish its live taps
  auto gather = [&](const GroupHalo& gh, const int (&src)[S::kRows], int bits) {
#pragma unroll
    for (int j = 0; j < S::kRows; ++j) {
      const int r = ttid + S::kTeamThreads * j;
      if (r >= gh.n_slots * kLayer) break;
      const __nv_bfloat16* from = state + (src[j] >= 0 ? static_cast<size_t>(src[j]) * C : 0);
      const uint32_t to = smem_addr(halo + r * S::kStride);
#pragma unroll
      for (int v = 0; v < C / 8; ++v) cp_async16(to + 16 * v, from + 8 * v, src[j] >= 0 ? 16 : 0);
    }
    if (lane == 0) tw[twarp] = bits;
  };
  auto tap_mask = [&]() {
    int taps = 0;
#pragma unroll
    for (int i = 0; i < 4 * S::kSplit; ++i) taps |= tw[i];
    return taps;
  };
  const int a_cell = lane % 16, a_koff = (lane / 16) * 8;
  // shared address of this lane's A row of tap k, its plane's layer kz
  auto a_row = [&](const GroupHalo& gh, int k) {
    const int kz = k / 9, ky = (k / 3) % 3, kx = k % 3;
    const int slot = kz == 0 ? gh.slot[0] : (kz == 1 ? gh.slot[1] : gh.slot[2]);
    const int h = slot * kLayer + (a_cell / 4 + ky) * 6 + a_cell % 4 + kx;
    return smem_addr(halo + h * S::kStride + a_koff);
  };
  uint32_t a[S::kNA][C / 16][4];         // A of the taps in flight
  uint32_t em[2][N / 8], er[2][N / 8];   // the epilogue's mask and residual

  if constexpr (S::kResident) {
    // Each warpgroup claims chunks of kChunk planes of the column order
    // (i = t * tz + z) from a counter, finds their live planes (a half-warp
    // reads a plane's 16 mask cells), writes the rows of the others as
    // zeros, and walks the live ones in groups of 4: it gathers a group's
    // halo, multiplies it and stores the epilogue, while the sources of the
    // next group and its epilogue operands load. The block's other
    // warpgroups fill the SM meanwhile, one streaming a chunk's mask and
    // zeros while another gathers or multiplies.
    int* live = reinterpret_cast<int*>(smem + S::kHead + 2 * (size_t(S::kWElems) +
                                                              S::kTeams * S::kHaloElems)) +
                wg * kScanInts;
    int* dead = live + kChunk;
    int* wcount = dead + kChunk;                 // [0, 4) live, [4, 8) dead a warp
    unsigned char* flag = reinterpret_cast<unsigned char*>(wcount + 8);
    int* claim = wcount + 8 + kChunk / 4;
    const int n_chunks = (tz * t1p + kChunk - 1) / kChunk;
    mbar_wait(bar0, 0);  // the weights have landed
    for (;;) {
      if (wtid == 0) *claim = atomicAdd(count, 1);
      wg_sync(wg);
      const int c = *claim;
      if (c >= n_chunks) break;
      const int nl = scan_chunk<__nv_bfloat16, CO, 128>(mask, out, t1p, tz, c * kChunk, wtid,
                                                        live, dead, wcount, flag,
                                                        [&] { wg_sync(wg); });
      const int ng = (nl + kGroup - 1) / kGroup;
      GroupHalo gh, gn;
      int src[S::kRows], bits = 0;
      if (ng > 0) {
        sources(live, nl, 0, gh, src, bits);
        if (gh.q >= 0) epi_load<CO, N>(gh.q, 0, lane, mask, resid, em, er);
      }
      for (int g = 0; g < ng; ++g) {
        gather(gh, src, bits);
        cp_async_commit();
        if (g + 1 < ng) sources(live, nl, g + 1, gn, src, bits);
        cp_async_wait_all();  // this thread's copies have landed
        wg_sync(wg);          // ... and everyone's, with their tap masks
        int taps = tap_mask();
        float acc[N / 2];
#pragma unroll
        for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
        // two taps in flight: A of the next loads while the last multiplies
        while (taps) {
#pragma unroll
          for (int i = 0; i < S::kNA; ++i) {
            if (taps) {
              const int k = __ffs(taps) - 1;
              taps &= taps - 1;
              tap_issue<C, CO, N>(acc, a[i], a_row(gh, k), smem_addr(wsm + k * S::kTapElems));
              wgmma_wait<S::kNA - 1>();
            }
          }
        }
        acc_done<N>(acc);
        if (gh.q >= 0) epi_store<CO, N>(acc, gh.q, 0, lane, scale, shift, em, er, out, relu);
        wg_sync(wg);  // the halo is free for the next group
        if (g + 1 < ng) {
          gh = gn;
          if (gh.q >= 0) epi_load<CO, N>(gh.q, 0, lane, mask, resid, em, er);
        }
      }
    }
  } else {
    // Streamed weights. The block's teams take a group each per pass (at
    // C = 128 the two warpgroups are one team, each with half of the output
    // channels); every pass runs the 27 taps in order through a ring of
    // kRing slots. The producer warp loads tap after tap into the ring
    // (full[s]: the copy has landed); each consumer warp releases a slot
    // once its wgmma on it is done (empty[s]: 4 kWG arrivals).
    const int n = *count, n_groups = (n + kGroup - 1) / kGroup;
    const int n_pass = (n_groups + S::kTeams - 1) / S::kTeams;
    const uint32_t full0 = bar0, empty0 = bar0 + 8 * S::kRing;
    if (wg == S::kWG) {  // the producer warp
      uint32_t seq = 0;
      for (int q = blockIdx.x; q < n_pass; q += gridDim.x) {
        for (int k = 0; k < 27; ++k, ++seq) {
          const int slot = seq % S::kRing;
          if (lane == 0) {
            mbar_wait(empty0 + 8 * slot, ((seq / S::kRing) & 1) ^ 1);
            mbar_expect_tx(full0 + 8 * slot, S::kTapBytes);
            bulk_load(smem_addr(wsm + slot * S::kTapElems), wb + k * S::kTapElems,
                      S::kTapBytes, full0 + 8 * slot);
          }
        }
      }
      return;
    }
    uint32_t seq = 0;  // taps consumed; slot seq % kRing
    for (int q = blockIdx.x; q < n_pass; q += gridDim.x) {
      const int g = q * S::kTeams + team;
      const bool live = g < n_groups;
      GroupHalo gh;
      gh.q = -1;
      if (live) {
        int src[S::kRows], bits;
        sources(list, n, g, gh, src, bits);
        gather(gh, src, bits);
        cp_async_commit();
        if (gh.q >= 0) epi_load<CO, N>(gh.q, n0, lane, mask, resid, em, er);
        cp_async_wait_all();
      }
      team_sync<S::kSplit>(wg);  // the halo and the tap masks are in place
      const int taps = live ? tap_mask() : 0;
      float acc[N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
      // a tap's wgmma runs while the next slot is awaited and its A loads;
      // the slot before is released once its wgmma is done
      auto step = [&](int k, uint32_t (&ak)[C / 16][4]) {
        const int slot = seq % S::kRing;
        mbar_wait(full0 + 8 * slot, (seq / S::kRing) & 1);
        if ((taps >> k) & 1) {
          tap_issue<C, CO, N>(acc, ak, a_row(gh, k),
                              smem_addr(wsm + slot * S::kTapElems + n0 * 8));
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();  // the other A buffer is free again, as after a tap
        }
        if (k > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((seq - 1) % S::kRing));
        ++seq;
      };
      for (int k = 0; k < 27; k += 2) {
        step(k, a[0]);
        if (k + 1 < 27) step(k + 1, a[1]);
      }
      acc_done<N>(acc);
      if (lane == 0) mbar_arrive(empty0 + 8 * ((seq - 1) % S::kRing));
      if (gh.q >= 0) epi_store<CO, N>(acc, gh.q, n0, lane, scale, shift, em, er, out, relu);
      team_sync<S::kSplit>(wg);  // every warp of the team is done with the halo
    }
  }
}

// ---------------------------------------------------------------------------
// float32 state: CUDA-core FMAs, a thread per (plane, cell) and 16 channels
// ---------------------------------------------------------------------------

template <int C, int CO>
struct FmaShape {
  static constexpr int kTpg = kThreads / (CO / 16);      // threads per channel group
  static constexpr int kPlanes = kTpg / 16;              // planes per block
  static constexpr int kStride = C + 1;                  // odd word stride
  static constexpr size_t kSmem =
      sizeof(float) * (C * CO + size_t(kPlanes) * kHalo * kStride) +
      sizeof(int) * kPlanes * (kHalo + 1);
  static_assert(kSmem <= kSmemMax, "shared memory");
  static_assert(kBlk % kPlanes == 0 && C % 16 == 0 && CO % 16 == 0, "shape");
};

__device__ __forceinline__ void fma16(float x, const float* w, float* acc) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float4 v = w4[r];
    acc[4 * r + 0] = fmaf(x, v.x, acc[4 * r + 0]);
    acc[4 * r + 1] = fmaf(x, v.y, acc[4 * r + 1]);
    acc[4 * r + 2] = fmaf(x, v.z, acc[4 * r + 2]);
    acc[4 * r + 3] = fmaf(x, v.w, acc[4 * r + 3]);
  }
}

// w: weights (27, C, CO) float
template <int C, int CO>
__global__ void __launch_bounds__(kThreads)
tile_subm_fma(const float* __restrict__ state, const int* __restrict__ tgt,
              const float* __restrict__ w, const float* __restrict__ scale,
              const float* __restrict__ shift, const float* __restrict__ mask,
              const float* __restrict__ resid, float* __restrict__ out,
              const int* __restrict__ list, const int* __restrict__ count, int t1p, int tz,
              int relu) {
  using S = FmaShape<C, CO>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* wsm = reinterpret_cast<float*>(smem);
  float* halo = wsm + C * CO;
  int* src = reinterpret_cast<int*>(halo + S::kPlanes * kHalo * S::kStride);
  int* qs = src + S::kPlanes * kHalo;

  const int tid = threadIdx.x;
  const int g = tid / S::kTpg, row = tid % S::kTpg;   // channel group, (plane, cell)
  const int cell = row % 16, col = cell * CO + g * 16;
  const int n = *count;
  for (int i0 = blockIdx.x * S::kPlanes; i0 < n; i0 += gridDim.x * S::kPlanes) {
    next_planes<S::kPlanes>(list, i0, n, qs);
    halo_sources<S::kPlanes>(tgt, t1p, tz, qs, src);
    __syncthreads();
    for (int i = tid; i < S::kPlanes * kHalo * C; i += kThreads) {
      const int r = i / C, ci = i % C, s = src[r];
      halo[r * S::kStride + ci] = s >= 0 ? state[static_cast<size_t>(s) * C + ci] : 0.f;
    }
    float acc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = 0.f;
    for (int k = 0; k < 27; ++k) {
      __syncthreads();  // halo staged / the previous tap's readers are done
      for (int i = tid * 4; i < C * CO; i += kThreads * 4)
        *reinterpret_cast<float4*>(wsm + i) =
            *reinterpret_cast<const float4*>(w + static_cast<size_t>(k) * C * CO + i);
      __syncthreads();
      const float* hrow = halo + ((row / 16) * kHalo +
                                  halo_of(cell, k / 9, (k / 3) % 3, k % 3)) * S::kStride;
      const float* wg = wsm + g * 16;
#pragma unroll 4
      for (int ci = 0; ci < C; ++ci) fma16(hrow[ci], wg + ci * CO, acc);
    }

    const int q = qs[row / 16];
    if (q < 0) continue;
    const size_t at = static_cast<size_t>(q) * 16 * CO + col;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float v = acc[j] * scale[col + j] + shift[col + j];
      if (resid != nullptr) v += resid[at + j];
      if (relu) v = fmaxf(v, 0.f);
      out[at + j] = v * mask[at + j];
    }
  }
}

// allow `smem` bytes of dynamic shared memory to the kernel
template <typename K>
int opt_in_smem(K kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

// The compaction, then the conv on `threads`-thread persistent blocks, as
// many as fit on the card at once and at most one a `unit` planes (the
// occupancy query needs the kernel's shared memory allowed first).
template <typename T, int CO, typename K>
int launch(K kernel, bool compact, int threads, int unit, size_t smem, const void* state,
           const void* tgt, const void* w, const void* scale, const void* shift,
           const void* mask, const void* resid, void* out, int* list, int* count, int t1p,
           int tz, int relu, cudaStream_t stream) {
  if (t1p % kBlk != 0 || tz < 1) return -2;
  const int n = tz * t1p;
  if (int e = opt_in_smem(kernel, smem)) return e;
  cudaError_t e = cudaMemsetAsync(count, 0, sizeof(int), stream);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int units = (n + unit - 1) / unit;
  const int blocks = units < sms * per_sm ? units : sms * per_sm;
  if (compact)
    tile_live<T, CO><<<(n + kChunk - 1) / kChunk, kThreads, 0, stream>>>(
        static_cast<const T*>(mask), static_cast<T*>(out), t1p, tz, count, list);
  kernel<<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(state), static_cast<const int*>(tgt), static_cast<const T*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<const T*>(mask), static_cast<const T*>(resid), static_cast<T*>(out), list,
      count, t1p, tz, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the compaction and the conv on `stream`; returns the
// cudaGetLastError() code (0 = launched), -1 for a (C, Co) pair the kernel is
// not built for, -2 for a T1p that is not a whole number of plan blocks.
// dtype 0 = float32 state with w (27, C, Co); dtype 1 = bfloat16 state with w
// in wgmma's B layout (plane_kernel.wgmma_weights). resid may be null. list
// (tz * T1p int32) and count (one int32) are scratch.
extern "C" int s2d_tile_subm(const void* state, const void* tgt, const void* w,
                             const void* scale, const void* shift, const void* mask,
                             const void* resid, void* out, void* list, void* count, int tz,
                             int t1p, int c, int co, int dtype, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* l = static_cast<int*>(list);
  int* n = static_cast<int*>(count);
#define S2D_TILE_CASE(CI, CO_)                                                            \
  if (c == CI && co == CO_) {                                                             \
    using W = WgShape<CI, CO_>;                                                           \
    using F = FmaShape<CI, CO_>;                                                          \
    if (dtype == 1)                                                                       \
      return launch<__nv_bfloat16, CO_>(tile_subm_wgmma<CI, CO_>, !W::kResident,         \
                                        W::kThreads, W::kUnit, W::kSmem, state, tgt, w,  \
                                        scale, shift, mask, resid, out, l, n, t1p, tz,   \
                                        relu, s);                                         \
    return launch<float, CO_>(tile_subm_fma<CI, CO_>, true, kThreads, F::kPlanes, F::kSmem, \
                              state, tgt, w, scale, shift, mask, resid, out, l, n, t1p,   \
                              tz, relu, s);                                               \
  }
  S2D_TILE_CASE(16, 16)
  S2D_TILE_CASE(32, 32)
  S2D_TILE_CASE(64, 64)
  S2D_TILE_CASE(128, 128)
#undef S2D_TILE_CASE
  return -1;
}
