// Batched greedy NMS on the H100: one thread block per candidate set.
//
// Replaces the Pallas TPU kernel `_nms_kernel` launched by
// `nms_mask_pallas` in odtpu/ops/pallas/nms_kernel.py. Same function:
// for each of N independent candidate sets of K boxes, sorted by score
// descending, box i kills a later box j when
//     inter > iou_thresh * union  &&  union > 0
// (union from the unclipped areas, intersection clamped at 0); a box
// with score <= score_thresh is dead on arrival; a live box kills the
// later boxes it overlaps, in order.
//
// Two entry points share the set's work (`nms_set` below):
// - odtpu_nms_mask: [N, K, 4] boxes and [N, K] scores in, a bool [N, K]
//   alive mask out (the Pallas kernel's contract). The dense detect
//   contract (rows compacted survivors-first, DetectOut) calls it;
// - odtpu_nms_rows: the serving path's whole per-class step. It gathers
//   set n's boxes itself from decoded[n / Cf] by the top-k order, and
//   writes rows [N, K, 5] = (score * alive, x1, y1, x2, y2), so the
//   candidate gather, its copy, the mask, the multiply and the concat
//   are not separate launches.
//
// What bounds it. At the detect path's shapes (B = 32, N = 640 sets,
// K = 200) the call moves ~3-6 MB, under 2 us at 3.35 TB/s, and tests
// ~11 M needed pairs of ~14 f32 operations, ~2.2 us at 67 TFLOP/s.
// Neither peak is reachable: of a pair's ~15 instructions, 6 max/min
// and 2 compares run on the SM's ALU pipe at half the FADD/FMUL rate,
// so the kill matrix is bound by that pipe (~18 cycles a warp of pairs),
// and the greedy scan is a dependent chain of K steps per set. Tensor
// cores, TMA and wgmma do not apply: there is no matrix product, and a
// set fits in a few KB of shared memory that one pass of 16-byte loads
// fills.
//
// Design:
// - one block of 256 threads per set (on the H100 128 ran as fast and
//   512 slower, PERF.md); the set's boxes (one float4 each), areas,
//   scores and "dead on arrival" bits (packed by __ballot_sync) go to
//   shared memory;
// - the kill matrix, bit t of word w of row i meaning "box i kills box
//   32w + t", is built in tiles of 32 rows (chunk c) by one word w,
//   upper triangle only (w >= c): lane l holds box i = 32c + l in
//   registers and runs over the boxes j of word w, which every lane
//   reads at the same address (a shared-memory broadcast), setting bit
//   t in a register. No divide, no ballot, one store per lane and tile.
//   Groups of 8 columns that lie wholly past K are not tested, and a
//   tile whose rows or columns are all dead on arrival is not built:
//   the scan never uses its bits;
// - a tile is 33 consecutive words (row t at offset t, one word of
//   padding), so its store, the scan's broadcast reads of it and the
//   scan's reads of one word per lane across tiles are free of bank
//   conflicts, at fixed offsets;
// - warp 0 scans while the other warps build the tiles column by column
//   and count each finished tile in ready[w]. Chunk c is decided as
//   soon as column c is complete: each lane ORs row `lane` of the kept
//   rows of every earlier chunk into word c (one __reduce_or_sync),
//   then the chunk's own 32 decisions run on one warp-uniform register
//   whose rows were loaded up front, so the serial chain holds only a
//   test and an OR per box, with no shuffle and no load in it.
// The TPU version's 128-lane padding, 32-set blocking and one-hot MXU
// row extraction existed only because Mosaic has no dynamic lane index;
// none of it is carried over.
//
// Numerics equal the Pallas kernel's bit for bit: float threshold, the
// division-free test, and no FMA contraction in the areas or the union
// (the __f*_rn intrinsics round each step on its own, as XLA does); the
// max / min propagate a NaN as jnp.maximum and torch.maximum do.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// threads per block: warp 0 scans, the other 7 build the kill matrix
constexpr int kThreads = 256;
// the kill matrix takes ~160 KB of shared memory at K = 1024, of the
// 227 KB a block may have
constexpr int kMaxK = 1024;

// max / min that return NaN when either side is NaN (fmaxf / fminf
// would drop it); one FMNMX instruction each on sm_80 and later
__device__ __forceinline__ float nan_max(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float nan_min(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// bits |= bit when a > b and c > 0: two compares into one predicate and
// one predicated OR (the compiler's own select-and-OR costs two more
// ALU-pipe instructions per pair)
__device__ __forceinline__ void set_if(uint32_t& bits, uint32_t bit, float a,
                                       float b, float c) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.gt.f32 p, %1, %2;\n\t"
      "setp.gt.and.f32 p, %3, 0f00000000, p;\n\t"
      "@p or.b32 %0, %0, %4;\n\t}"
      : "+r"(bits)
      : "f"(a), "f"(b), "f"(c), "r"(bit));
}

__host__ __device__ inline int words_of(int k) { return (k + 31) / 32; }

// A tile of the kill matrix is word w of the 32 rows of chunk c, kept
// as kTile consecutive words: row t of the chunk at offset t. One word
// of padding makes lanes that read one tile each (the scan) hit 32
// different banks; lanes that write one tile (the build) do already.
constexpr int kTile = 33;

constexpr uint32_t kAll = 0xffffffffu;

// The set's shared memory, carved from one dynamic allocation.
struct SetSmem {
  float4* box;     // [kp]
  float* area;     // [kp]
  float* score;    // [kp]
  uint32_t* kill;  // [words, words] tiles of kTile words
  uint32_t* dead;  // [words]: dead on arrival (low score, or j >= k)
  uint32_t* kept;  // [words]: the scan's result
  int* ready;      // [words]: tiles of column w built so far
};

// Called by every thread first; zeroes the ready counts (words is at
// most 32).
__device__ __forceinline__ SetSmem carve(int k) {
  extern __shared__ float4 smem[];
  const int words = words_of(k);
  SetSmem s;
  s.box = smem;
  s.area = reinterpret_cast<float*>(s.box + 32 * words);
  s.score = s.area + 32 * words;
  s.kill = reinterpret_cast<uint32_t*>(s.score + 32 * words);
  s.dead = s.kill + words * words * kTile;
  s.kept = s.dead + words;
  s.ready = reinterpret_cast<int*>(s.kept + words);
  if (threadIdx.x < words) s.ready[threadIdx.x] = 0;
  return s;
}

// Candidate j of the set to shared memory; called for every j < kp by
// whole warps, so the ballot sees 32 candidates at once.
__device__ __forceinline__ void put(const SetSmem& s, int j, float4 b,
                                    float score, bool dead) {
  s.box[j] = b;
  s.area[j] = __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
  s.score[j] = score;
  const uint32_t word = __ballot_sync(kAll, dead);
  if ((threadIdx.x & 31) == 0) s.dead[j >> 5] = word;
}

// Row chunk c, word w of the kill matrix, by one warp, then counted in
// ready[w] once every lane's word is in shared memory.
__device__ __forceinline__ void build_tile(const SetSmem& s, int c, int w,
                                           int k, int words, float thr) {
  const int lane = threadIdx.x & 31;
  const float4 bi = s.box[32 * c + lane];
  const float ai = s.area[32 * c + lane];
  // columns j >= k are padding: test only the groups of 8 that hold
  // some j < k (at K = 200 the last word has 8 of 32)
  const int groups = (min(32, k - 32 * w) + 7) >> 3;
  uint32_t bits = 0;
  for (int g = 0; g < groups; ++g) {
    const float4* bj = s.box + 32 * w + 8 * g;
    const float* aj = s.area + 32 * w + 8 * g;
    uint32_t hits = 0;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float4 b = bj[t];
      const float iw = nan_max(__fsub_rn(nan_min(bi.z, b.z),
                                         nan_max(bi.x, b.x)), 0.0f);
      const float ih = nan_max(__fsub_rn(nan_min(bi.w, b.w),
                                         nan_max(bi.y, b.y)), 0.0f);
      const float inter = __fmul_rn(iw, ih);
      const float uni = __fsub_rn(__fadd_rn(ai, aj[t]), inter);
      set_if(hits, 1u << t, inter, __fmul_rn(thr, uni), uni);
    }
    bits |= hits << (8 * g);
  }
  if (w == c) bits &= lane == 31 ? 0u : kAll << (lane + 1);  // j > i
  const int left = k - 32 * w;
  if (left < 32) bits &= (1u << left) - 1u;  // j < k
  s.kill[(c * words + w) * kTile + lane] = bits;
  __threadfence_block();
  __syncwarp();
  if (lane == 0) atomicAdd(&s.ready[w], 1);
}

// Spin until *count reaches target. The tile warps always get there; the
// bound turns a miscount into a launch error instead of a hang.
__device__ __forceinline__ void wait_for(const int* count, int target) {
  const volatile int* c = count;
  for (int spins = 0; *c < target; ++spins) {
    if (spins > (1 << 24)) __trap();
    __nanosleep(32);
  }
  __threadfence_block();
}

// The kill matrix and the greedy scan over a set already in shared
// memory; leaves the kept boxes' bits in s.kept. Warp 0 scans while the
// other warps build the tiles column by column, so the scan of chunk c
// runs as soon as column c (its tiles with every earlier chunk) is built.
__device__ void nms_set(const SetSmem& s, int k, float thr) {
  const int words = words_of(k);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();

  if (warp > 0) {
    // a tile (c, w) is needed when chunk c has a live row and word w a
    // live column; needed tiles are dealt round-robin to the tile warps
    constexpr int tile_warps = kThreads / 32 - 1;
    int turn = 0;
    for (int w = 0; w < words; ++w) {
      if (s.dead[w] == kAll) continue;
      for (int c = 0; c <= w; ++c) {
        if (s.dead[c] == kAll) continue;
        if (turn == warp - 1) build_tile(s, c, w, k, words, thr);
        if (++turn == tile_warps) turn = 0;
      }
    }
  } else {
    int live = 0;  // chunks 0..c with a live row
    for (int c = 0; c < words; ++c) {
      uint32_t kept = 0;
      if (s.dead[c] != kAll) {
        wait_for(&s.ready[c], ++live);
        // word c as the kept rows of earlier chunks leave it: lane t
        // takes row t of each earlier chunk, and the warp ORs them
        uint32_t acc = 0;
        for (int e = 0; e < c; ++e) {
          acc |= s.kill[(e * words + c) * kTile + lane] &
                 (0u - ((s.kept[e] >> lane) & 1u));
        }
        uint32_t cur = s.dead[c] | __reduce_or_sync(kAll, acc);
        // the chunk's own rows, decided in order: only a test and an OR
        // on a register in the dependent chain
        const uint32_t* diag = s.kill + (c * words + c) * kTile;
        uint32_t own[32];
#pragma unroll
        for (int t = 0; t < 32; ++t) own[t] = diag[t];
#pragma unroll
        for (int t = 0; t < 32; ++t) {
          if (!(cur & (1u << t))) cur |= own[t];
        }
        kept = ~cur;
      }
      if (lane == 0) s.kept[c] = kept;
      __syncwarp();
    }
  }
  __syncthreads();
}

__device__ __forceinline__ bool kept_bit(const SetSmem& s, int j) {
  return (s.kept[j >> 5] >> (j & 31)) & 1u;
}

__global__ void __launch_bounds__(kThreads)
nms_mask_kernel(const float4* __restrict__ boxes,  // [N, K]
                const float* __restrict__ scores,  // [N, K]
                bool* __restrict__ alive,          // [N, K]
                int k, float iou_thresh, float score_thresh) {
  const SetSmem s = carve(k);
  const int64_t base = static_cast<int64_t>(blockIdx.x) * k;
  const int kp = 32 * words_of(k);
  for (int j = threadIdx.x; j < kp; j += kThreads) {
    float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float sc = 0.0f;
    if (j < k) {
      b = boxes[base + j];
      sc = scores[base + j];
    }
    put(s, j, b, sc, j >= k || !(sc > score_thresh));
  }
  nms_set(s, k, iou_thresh);
  for (int j = threadIdx.x; j < k; j += kThreads) {
    alive[base + j] = kept_bit(s, j);
  }
}

__global__ void __launch_bounds__(kThreads)
nms_rows_kernel(const float4* __restrict__ decoded,  // [B, P]
                const int64_t* __restrict__ order,   // [N, ld_order]
                const float* __restrict__ scores,    // [N, ld_scores]
                float* __restrict__ rows,            // [N, K, 5]
                int k, int cf, int p, int64_t ld_order, int64_t ld_scores,
                float iou_thresh, float score_thresh) {
  const SetSmem s = carve(k);
  const int set = blockIdx.x;
  const float4* image = decoded + static_cast<int64_t>(set / cf) * p;
  const int kp = 32 * words_of(k);
  const float nan = __int_as_float(0x7fc00000);
  for (int j = threadIdx.x; j < kp; j += kThreads) {
    float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float sc = 0.0f;
    if (j < k) {
      const int64_t idx = order[set * ld_order + j];
      sc = scores[set * ld_scores + j];
      // an index outside the image reads nothing and gives a NaN box
      b = (idx >= 0 && idx < p) ? image[idx]
                                : make_float4(nan, nan, nan, nan);
    }
    put(s, j, b, sc, j >= k || !(sc > score_thresh));
  }
  nms_set(s, k, iou_thresh);
  // (score * alive, x1, y1, x2, y2): a product, as top_scores * alive
  // is, so -0.0, inf and NaN scores come out as they do there
  float* out = rows + static_cast<int64_t>(set) * k * 5;
  const float* coords = reinterpret_cast<const float*>(s.box);
  for (int e = threadIdx.x; e < 5 * k; e += kThreads) {
    const int j = e / 5;
    const int col = e - 5 * j;
    out[e] = col == 0
                 ? __fmul_rn(s.score[j], kept_bit(s, j) ? 1.0f : 0.0f)
                 : coords[4 * j + col - 1];
  }
}

cudaError_t prepare(const void* kernel, int k, size_t smem) {
  if (k > kMaxK) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Shared memory one block needs for sets of k candidates.
size_t odtpu_nms_smem_bytes(int k) {
  const size_t words = words_of(k);
  return 32 * words * (sizeof(float4) + 2 * sizeof(float)) +
         sizeof(uint32_t) * (words * words * kTile + 3 * words);
}

// Each entry launches on `stream` and returns the launch's error code
// (cudaSuccess when the launch was accepted). The caller checks shapes,
// types, contiguity and 16-byte alignment of the box arrays.

cudaError_t odtpu_nms_mask(const float* boxes, const float* scores,
                           bool* alive, int n, int k, float iou_thresh,
                           float score_thresh, cudaStream_t stream) {
  if (n <= 0 || k <= 0) return cudaSuccess;
  const size_t smem = odtpu_nms_smem_bytes(k);
  const cudaError_t err = prepare(
      reinterpret_cast<const void*>(nms_mask_kernel), k, smem);
  if (err != cudaSuccess) return err;
  nms_mask_kernel<<<n, kThreads, smem, stream>>>(
      reinterpret_cast<const float4*>(boxes), scores, alive, k, iou_thresh,
      score_thresh);
  return cudaGetLastError();
}

cudaError_t odtpu_nms_rows(const float* decoded, const int64_t* order,
                           const float* scores, float* rows, int n, int k,
                           int cf, int p, int64_t ld_order,
                           int64_t ld_scores, float iou_thresh,
                           float score_thresh, cudaStream_t stream) {
  if (n <= 0 || k <= 0) return cudaSuccess;
  if (cf <= 0 || p <= 0) return cudaErrorInvalidValue;
  const size_t smem = odtpu_nms_smem_bytes(k);
  const cudaError_t err = prepare(
      reinterpret_cast<const void*>(nms_rows_kernel), k, smem);
  if (err != cudaSuccess) return err;
  nms_rows_kernel<<<n, kThreads, smem, stream>>>(
      reinterpret_cast<const float4*>(decoded), order, scores, rows, k, cf,
      p, ld_order, ld_scores, iou_thresh, score_thresh);
  return cudaGetLastError();
}

}  // extern "C"
