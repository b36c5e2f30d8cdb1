// Paged flash attention for Hopper (sm_90a): the serving hot loop.
//
// Two kernels over one paged KV pool of shape (n_pages, kv, page, dh),
// fp32, indexed through a per-lane page table ptab (b, m) int32 and a
// per-lane frontier pos (b,) int32:
//
//   paged_flash_decode   replaces veles_tpu/ops/pallas_kernels.py:367
//                        (paged_flash_decode).  c query positions per
//                        lane attend keys k <= q (plus window/sinks).
//   paged_flash_prefill  replaces veles_tpu/ops/pallas_kernels.py:443
//                        (paged_flash_prefill).  One page-aligned chunk
//                        (c == page) per lane attends the history keys
//                        strictly below pos, then its own K/V causally,
//                        then installs that K/V into pool page
//                        ptab[i, pos / page] IN PLACE (the TPU kernel's
//                        aliased outputs).
//
// Bound on the H100: bytes.  A decode step reads every live K/V page
// once and does 4 flops per key element (QK^T and PV), about 0.5 flop
// per byte, far under the fp32 ridge (67 TFLOP/s over 3.35 TB/s).  What
// the design does about it: only pages holding a key live for the lane
// are read (the band test runs before any load, so pages past the
// frontier or behind the window are skipped), each K and V row is read
// from device memory once per block, and o is the only output written.
//
// Decode (decode_split_kernel + combine_kernel, split-KV): a serving
// batch has few (lane, kv head) pairs (64 at b 8, kv 8), too few blocks for
// 132 SMs, so each lane's table is cut into contiguous ranges of pages
// (the count chosen on the host from the geometry alone; pos stays on the
// card).  A one-warp block walks its range in 32-key tiles, stages K and V
// through shared memory by coalesced cp.async with the next slab in
// flight, and leaves its (m, l, acc) in a workspace; a second kernel,
// launched with programmatic dependent launch, meets the ranges in a fixed
// order (no atomics: results repeat bit for bit).  One wrapper call, one
// launch count.
//
// Prefill (prefill_split_kernel + the same combine_kernel, split-KV): the
// engine prefills one lane's chunk at a time, so (lane, kv head) pairs are
// fewer still (8 at kv 8).  A block of 8 warps owns one (lane, kv head,
// tile of up to 64 query rows — all g c rows of the kv head at the
// serving config —, 32 E output features, split); the split is a
// contiguous range of the lane's table pages, the count again from the
// geometry alone, and the last split also walks the chunk's own c keys
// (from k_new/v_new).  Each warp owns RW rows of the tile.  The block
// stages each 32-key tile's K and V rows into shared memory by coalesced
// cp.async (16 bytes, 4 when dh % 4 != 0; K in slabs of 32 E columns, then
// the V slab of the block's features), two slabs in flight; every warp
// scores its rows against the staged keys (lane t against key t), runs the
// reference's online softmax per row, parks its P row in shared memory and
// sums P.V over the slab (lane e holding features e, e+32, ...).  So each
// history page is read once per (kv head, row tile, feature block), not
// once per four rows.  The split's (m, l, acc) go to the workspace and
// combine_kernel meets them in split order, as for decode.  The same
// launch installs the chunk's K/V into pool page ptab[i, pos / page] (a
// slice a block, coalesced stores): no block reads that page, whose keys
// all sit at or past the frontier.  At the serving shape (b 1, kv 8, 32
// rows, dh 64, 16 pages) that is 16 splits of one page, 128 blocks; a
// block's time goes to latency (pos, then the table, then the slabs) and
// to issuing its ~130 K fp32 FMAs on one SM, not to bytes.
//
// Masking follows the reference exactly: NEG_INF is finite (-1e30) and
// ADDED to the scaled score s = (q.k) / sqrt(dh) (prefill multiplies by
// 1 / sqrt(dh), within an ulp of the score), so a row's masked
// keys seen before its first live key add transient terms that the
// online rescale later multiplies by exp(-1e30 - max) == 0.  A page
// with no key live for any row of the lane is skipped (never read):
// its terms would be those same zeros.  Every query row has at least
// one live key (itself).
//
// Plain C interface (loaded with ctypes): each entry point launches on
// the given stream and returns cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int TILE = 32;                      // keys per tile, one a lane
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v += __shfl_xor_sync(FULL, v, o);
    return v;
}

// The band of the reference's _band: ``strict`` selects the prefill
// history base (k < frontier) over the causal base (k <= q).
__device__ __forceinline__ bool band_live(int k, int q_pos, int frontier,
                                          bool strict, int window,
                                          int sinks) {
    bool live = strict ? (k < frontier) : (k <= q_pos);
    if (window > 0) {
        bool in_w = k > q_pos - window;
        if (sinks > 0) in_w = in_w || (k < sinks);
        live = live && in_w;
    }
    return live;
}

// Does table page j hold a key live for ANY query row of the lane?
// (uniform over the lane's rows: it depends on the lane and j only)
__device__ __forceinline__ bool page_live(int j, int page, int p0, int c,
                                          bool prefill, int window,
                                          int sinks) {
    const int kb = j * page;
    bool live = prefill ? (kb < p0) : (kb <= p0 + c - 1);
    if (window > 0)
        live = live && (kb + page - 1 > p0 - window || kb < sinks);
    return live;
}

// cp.async of 16 or 4 bytes; with in == false nothing is read and the
// destination is zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most n of this thread's committed groups are in flight.
template <int n>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// Programmatic dependent launch (Hopper): the combine kernel is launched
// while the split kernel runs and waits here for it to complete and its
// writes to be visible; the split kernel lets it launch at once.
__device__ __forceinline__ void grid_dependency_wait() {
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void launch_dependents() {
    asm volatile("griddepcontrol.launch_dependents;\n" ::);
}

// Decode, split over the lane's pages (split-KV).  A block is one warp and
// owns (lane i, kv head, R query rows, 32 E output features, one split: a
// contiguous range of the table's pages).  It walks the split's keys in
// tiles of 32 (lane t scores key t), tiles with no live key skipped before
// anything is read, and stages each tile through shared memory in slabs
// of 32 rows x 32 E columns: the K slabs that cover dh (one when dh <= 256),
// then the V slab of the block's features.  Slabs are double-buffered:
// 16-byte cp.async (4-byte when dh % 4 != 0), one key row of a page a
// contiguous run, so the warp's copies are coalesced, while the slab
// before is scored or summed.  Slab rows are 32 E + 4 floats apart (16-byte
// path) or 32 E + 1 (4-byte path), so lane-per-key reads of float4s, or of
// floats, are free of bank conflicts.  The split's (m, l, acc) go to the
// workspace (rows x splits, then combine_kernel), or straight to o when
// there is one split.
template <int R, int E>
__global__ void __launch_bounds__(32)
decode_split_kernel(const float* __restrict__ q,
                    const float* __restrict__ k_pool,
                    const float* __restrict__ v_pool,
                    const int* __restrict__ ptab,
                    const int* __restrict__ pos, float* __restrict__ o,
                    float* __restrict__ ws, int h, int kv, int c, int dh,
                    int page, int m, int window, int sinks,
                    int n_row_blocks, int splits, int vec) {
    constexpr int FB = 32 * E;                  // features of one block
    const int ld = vec ? FB + 4 : FB + 1;       // slab row stride
    extern __shared__ __align__(16) float smem[];   // two slabs, then q
    float* q_s = smem + 2 * TILE * ld;          // R * dh

    launch_dependents();
    const int lane = threadIdx.x;
    const int i = blockIdx.x;
    const int kvh = blockIdx.y;
    const int split = blockIdx.z % splits;
    const int rb = (blockIdx.z / splits) % n_row_blocks;
    const int f0 = (blockIdx.z / splits / n_row_blocks) * FB;
    const int g = h / kv;
    const int row0 = rb * R;
    const int nrows = min(R, g * c - row0);
    const int nf = min(FB, dh - f0);
    const int* ptab_row = ptab + (size_t)i * m;
    // the split: pages [pg0, pg1) of the table.  The first tile's table
    // entries are read before pos (a table read, not a pool read), so the
    // two reads overlap
    const int per = (m + splits - 1) / splits;
    const int pg0 = split * per, pg1 = min(m, pg0 + per);
    const int key0 = pg0 * page;
    const int pid0 = key0 + lane < pg1 * page ? ptab_row[(key0 + lane) / page]
                                              : 0;
    const int p0 = pos[i];
    const float scale = sqrtf((float)dh);

    for (int x = lane; x < R * dh; x += TILE) {
        const int r = x / dh, e = x - r * dh;
        float v = 0.f;
        if (r < nrows) {
            const int row = row0 + r;
            const int head = kvh * g + row / c;
            v = q[(((size_t)i * h + head) * c + row % c) * dh + e];
        }
        q_s[x] = v;
    }
    __syncwarp();

    // the split's keys, cut at the last page that can hold a key at or
    // below the lane's last query
    const int key1 = min(pg1, (p0 + c - 1) / page + 1) * page;
    const int n_kc = (dh + FB - 1) / FB;        // K slabs a tile

    // the first tile at or after k0 holding a live key: lane t's key row
    // in the pool and whether it is live; present = the live lanes
    struct Tile {
        int k0;
        size_t off;
        bool has;
        unsigned present;
    };
    auto find = [&](int k0) {
        for (; k0 < key1; k0 += TILE) {
            const int key = k0 + lane;
            const int j = key / page;
            const bool has = key < key1
                && page_live(j, page, p0, c, false, window, sinks);
            const int pid = k0 == key0 ? pid0 : has ? ptab_row[j] : 0;
            const size_t off = has
                ? (((size_t)pid * kv + kvh) * page + (key - j * page)) * dh
                : 0;
            const unsigned present = __ballot_sync(FULL, has);
            if (present) return Tile{k0, off, has, present};
        }
        return Tile{key1, 0, false, 0u};
    };
    // slab sidx of tile tl into dst: K columns [sidx FB, +FB) for sidx <
    // n_kc, else V columns [f0, f0 + FB); zero outside the live rows and dh
    auto stage = [&](const Tile& tl, int sidx, float* dst) {
        const float* pool = sidx < n_kc ? k_pool : v_pool;
        const int col0 = sidx < n_kc ? sidx * FB : f0;
        if (vec) {
            constexpr int n4 = FB / 4;
            for (int x = lane; x < TILE * n4; x += TILE) {
                const int r = x / n4, cc = (x - r * n4) * 4;
                const size_t off = __shfl_sync(FULL, tl.off, r);
                const bool in = __shfl_sync(FULL, tl.has, r)
                                && col0 + cc < dh;
                cp_async16(dst + r * ld + cc, in ? pool + off + col0 + cc
                                                 : pool, in);
            }
        } else {
            for (int x = lane; x < TILE * FB; x += TILE) {
                const int r = x / FB, cc = x - r * FB;
                const size_t off = __shfl_sync(FULL, tl.off, r);
                const bool in = __shfl_sync(FULL, tl.has, r)
                                && col0 + cc < dh;
                cp_async4(dst + r * ld + cc, in ? pool + off + col0 + cc
                                                : pool, in);
            }
        }
    };

    float m_r[R], l_r[R], acc[R][E], s[R], p[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        m_r[r] = NEG_INF;
        l_r[r] = 0.f;                          // this lane's share of l
#pragma unroll
        for (int u = 0; u < E; ++u) acc[r][u] = 0.f;
    }

    Tile cur = find(key0);
    if (cur.present) {
        stage(cur, 0, smem);
        cp_commit();
    }
    int buf = 0;
    while (cur.present) {
        const Tile nxt = find(cur.k0 + TILE);
#pragma unroll
        for (int r = 0; r < R; ++r) s[r] = 0.f;
        for (int sidx = 0; sidx <= n_kc; ++sidx, buf ^= 1) {
            // the slab after this one (the next tile's first) in flight
            const bool last = sidx == n_kc;
            const Tile& ahead = last ? nxt : cur;
            if (ahead.present) {
                stage(ahead, last ? 0 : sidx + 1,
                      smem + (buf ^ 1) * TILE * ld);
                cp_commit();
                cp_wait<1>();
            } else {
                cp_wait<0>();
            }
            __syncwarp();
            const float* sl = smem + buf * TILE * ld;
            if (!last) {
                // scores: lane t's key row against each query row, over
                // this slab's head columns
                const float* kr = sl + lane * ld;
                const int col0 = sidx * FB, w = min(FB, dh - col0);
                if (vec) {
#pragma unroll 8
                    for (int e4 = 0; e4 < w / 4; ++e4) {
                        const float4 k4 =
                            reinterpret_cast<const float4*>(kr)[e4];
#pragma unroll
                        for (int r = 0; r < R; ++r) {
                            const float4 q4 = reinterpret_cast<const float4*>(
                                q_s + r * dh + col0)[e4];
                            s[r] += q4.x * k4.x;
                            s[r] += q4.y * k4.y;
                            s[r] += q4.z * k4.z;
                            s[r] += q4.w * k4.w;
                        }
                    }
                } else {
                    for (int e = 0; e < w; ++e) {
                        const float kx = kr[e];
#pragma unroll
                        for (int r = 0; r < R; ++r)
                            s[r] += q_s[r * dh + col0 + e] * kx;
                    }
                }
            } else {
                // P.V: key t's V row, lane e holding features e, e+32, ...
                // (absent keys have p = 0 and zero rows)
#pragma unroll 8
                for (int t = 0; t < TILE; ++t) {
                    const float* vr = sl + t * ld;
                    float v[E];
#pragma unroll
                    for (int u = 0; u < E; ++u) v[u] = vr[lane + 32 * u];
#pragma unroll
                    for (int r = 0; r < R; ++r) {
                        const float pt = __shfl_sync(FULL, p[r], t);
#pragma unroll
                        for (int u = 0; u < E; ++u) acc[r][u] += pt * v[u];
                    }
                }
            }
            if (sidx == n_kc - 1) {
                // online softmax: fold the tile into each row's (m, l, acc)
                const int key = cur.k0 + lane;
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    const int q_pos = p0 + (row0 + r) % c;
                    const float sr = cur.has
                        ? s[r] / scale + (band_live(key, q_pos, p0, false,
                                                    window, sinks)
                                          ? 0.f : NEG_INF)
                        : -INFINITY;
                    const float m_new = fmaxf(m_r[r], warp_max(sr));
                    const float alpha = expf(m_r[r] - m_new);
                    p[r] = expf(sr - m_new);       // 0 for an absent key
                    l_r[r] = l_r[r] * alpha + p[r];
                    m_r[r] = m_new;
#pragma unroll
                    for (int u = 0; u < E; ++u) acc[r][u] *= alpha;
                }
            }
            __syncwarp();
        }
        cur = nxt;
    }

    // the split's state: o itself when there is one split, else (m, l)
    // and acc in the workspace; a split with no live key writes m =
    // NEG_INF, l = 0, acc = 0, which the combine weighs exp(NEG_INF - M)
    // == 0
    const int rows = g * c;
    float* ws_acc = ws + (size_t)2 * gridDim.x * kv * rows * splits;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        if (r >= nrows) break;
        const float l_w = warp_sum(l_r[r]);
        const int row = row0 + r;
        const int head = kvh * g + row / c;
        const size_t state = (((size_t)i * kv + kvh) * rows + row) * splits
                             + split;
        if (splits > 1 && f0 == 0 && lane == 0) {
            ws[2 * state] = m_r[r];
            ws[2 * state + 1] = l_w;
        }
#pragma unroll
        for (int u = 0; u < E; ++u) {
            const int e = lane + 32 * u;
            if (e >= nf) continue;
            if (splits == 1)
                o[(((size_t)i * h + head) * c + row % c) * dh + f0 + e] =
                    acc[r][u] / l_w;
            else
                ws_acc[state * dh + f0 + e] = acc[r][u];
        }
    }
}

// The splits' states meet, in split order (no atomics, so results repeat
// bit for bit): o = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M), M the
// largest m_s.  One thread an output element; the states are read 16
// splits at a time, all 48 reads in flight together, and a later chunk
// rescales the sums so far to its larger M.
__global__ void __launch_bounds__(256)
combine_kernel(const float* __restrict__ ws, float* __restrict__ o, int b,
               int h, int kv, int c, int dh, int splits) {
    constexpr int CH = 16;                      // splits a chunk
    grid_dependency_wait();
    const int rows = (h / kv) * c;
    const size_t n = (size_t)b * kv * rows * dh;
    const size_t x = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (x >= n) return;
    const size_t st = x / dh;                   // (lane, kv head, row)
    const int e = (int)(x - st * dh);
    const float* ml = ws + 2 * st * splits;
    const float* acc = ws + 2 * n / dh * splits + st * splits * dh + e;
    float mx = NEG_INF, num = 0.f, den = 0.f;
    for (int s0 = 0; s0 < splits; s0 += CH) {
        float ms[CH], ls[CH], as[CH];
#pragma unroll
        for (int j = 0; j < CH; ++j) {
            const bool in = s0 + j < splits;
            ms[j] = in ? ml[2 * (s0 + j)] : NEG_INF;
            ls[j] = in ? ml[2 * (s0 + j) + 1] : 0.f;
            as[j] = in ? acc[(size_t)(s0 + j) * dh] : 0.f;
        }
        float m_new = mx;
#pragma unroll
        for (int j = 0; j < CH; ++j) m_new = fmaxf(m_new, ms[j]);
        const float alpha = expf(mx - m_new);
        num *= alpha;
        den *= alpha;
#pragma unroll
        for (int j = 0; j < CH; ++j) {
            if (s0 + j >= splits) break;
            const float a = expf(ms[j] - m_new);
            num += as[j] * a;
            den += ls[j] * a;
        }
        mx = m_new;
    }
    const int row = (int)(st % rows);
    const size_t lk = st / rows;                // lane * kv + kv head
    const int kvh = (int)(lk % kv), i = (int)(lk / kv);
    const int head = kvh * (h / kv) + row / c;
    o[(((size_t)i * h + head) * c + row % c) * dh + e] = num / den;
}

// Prefill, split over the lane's pages (split-KV).  A block is NW warps
// (blockDim.x / 32) and owns (lane i, kv head, a tile of RT = NW RW query
// rows, 32 E output features, one split: a contiguous range of the table's
// pages, and in the last split the chunk's c keys after them).  Warp w owns
// rows w RW .. w RW + RW - 1 of the tile.  The split's keys are walked in
// tiles of 32 (lane t scores key t), tiles with no live key skipped before
// anything is read; each tile is staged through shared memory in slabs of
// 32 rows x 32 E columns, the K slabs that cover dh and then the V slab of
// the block's features, through a ring of three (the next two slabs in
// flight while this one is scored or summed) and copied by the whole
// block: 16-byte cp.async (4-byte when dh % 4 != 0, VEC false), a key row
// of a page a contiguous run.
// Slab rows are 32 E + 4 floats apart (16-byte path) or 32 E + 1 (4-byte
// path), so lane-per-key reads are free of bank conflicts; the query rows
// sit whole in shared memory and are read as broadcasts.  After the tile's
// last K slab each warp runs the online softmax of its rows and parks their
// p in shared memory, which the V slab's P.V reads four keys at a time.  The
// split's (m, l, acc) go to the workspace (combine_kernel), or straight to
// o when there is one split.  The gridDim.z blocks of a (lane, kv head)
// also install the chunk into its pool page, a slice each.
template <int RW, int E, bool VEC>
__global__ void __launch_bounds__(256, 1)
prefill_split_kernel(const float* __restrict__ q,
                     const float* __restrict__ k_new,
                     const float* __restrict__ v_new,
                     float* __restrict__ k_pool, float* __restrict__ v_pool,
                     const int* __restrict__ ptab,
                     const int* __restrict__ pos, float* __restrict__ o,
                     float* __restrict__ ws, int h, int kv, int c, int dh,
                     int page, int m, int window, int sinks,
                     int n_row_tiles, int splits) {
    constexpr int FB = 32 * E;                  // features of one block
    const int nw = blockDim.x / 32;
    const int rt = nw * RW;                     // rows of the tile
    constexpr int ld = VEC ? FB + 4 : FB + 1;   // slab row stride
    extern __shared__ __align__(16) float smem[];   // 3 slabs, p, q, install
    float* p_s = smem + 3 * TILE * ld;          // rt * TILE
    float* q_s = p_s + rt * TILE;               // rt * dh
    float* inst_s = q_s + rt * dh;              // 2 * 4 * blockDim.x

    launch_dependents();
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int i = blockIdx.x;
    const int kvh = blockIdx.y;
    const int split = blockIdx.z % splits;
    const int tile_r = (blockIdx.z / splits) % n_row_tiles;
    const int f0 = (blockIdx.z / splits / n_row_tiles) * FB;
    const int g = h / kv;
    const int rows = g * c;
    const int row0 = tile_r * rt;               // the tile's first row
    const int wrow0 = row0 + warp * RW;         // this warp's first row
    const int nf = min(FB, dh - f0);
    const int* ptab_row = ptab + (size_t)i * m;
    const size_t chunk_kv = ((size_t)i * kv + kvh) * (size_t)c * dh;
    constexpr int width = VEC ? 4 : 1;          // floats a copy
    // the fused install, shared by the gridDim.z blocks of (lane, kv
    // head): block z copies the z-th slice of the chunk's rows into the
    // lane's target page.  Its first piece a thread is copied into shared
    // memory now (with the query rows, below) and stored at the end, when
    // the target page (pos, then a table read) has long arrived
    const size_t n_inst = (size_t)c * dh / width;
    const size_t slice = (n_inst + gridDim.z - 1) / gridDim.z;
    const size_t inst0 = blockIdx.z * slice + threadIdx.x;
    const size_t inst1 = (blockIdx.z + 1) * slice < n_inst
                         ? (blockIdx.z + 1) * slice : n_inst;
    float* k_in = inst_s + 4 * threadIdx.x;
    float* v_in = k_in + 4 * blockDim.x;
    if (inst0 < inst1) {
        if (VEC) {
            cp_async16(k_in, k_new + chunk_kv + 4 * inst0, true);
            cp_async16(v_in, v_new + chunk_kv + 4 * inst0, true);
        } else {
            cp_async4(k_in, k_new + chunk_kv + inst0, true);
            cp_async4(v_in, v_new + chunk_kv + inst0, true);
        }
    }
    // the split: pages [pg0, pg1) of the table, then (last split) the
    // chunk.  pos and the first tile's table entries are read first (a
    // table read, not a pool read), so that the two reads and the query
    // rows' copies are in flight together
    const int per = (m + splits - 1) / splits;
    const int pg0 = split * per, pg1 = min(m, pg0 + per);
    const bool last = split == splits - 1;
    const int key0 = pg0 * page;
    const int p0 = pos[i];
    const int pid0 = key0 + lane < pg1 * page ? ptab_row[(key0 + lane) / page]
                                              : 0;

    // the tile's query rows (zero past the last row)
    for (int x = threadIdx.x; x < rt * (dh / width); x += blockDim.x) {
        const int r = x / (dh / width), e = (x - r * (dh / width)) * width;
        const int row = row0 + r;
        const bool in = row < rows;
        const float* src =
            in ? q + (((size_t)i * h + kvh * g + row / c) * c + row % c) * dh
                     + e
               : q;
        if (VEC) cp_async16(q_s + r * dh + e, src, in);
        else cp_async4(q_s + r * dh + e, src, in);
    }
    cp_commit();
    // the scores' scale, 1 / sqrt(dh) (the reference divides by sqrt(dh):
    // within an ulp of the score)
    const float inv_scale = 1.f / sqrtf((float)dh);

    // the split's keys as one run: history keys [key0, key1) (every key
    // below the frontier in the range), then the chunk's c keys
    const int key1 = max(key0, min(pg1 * page, p0));
    const int tj = p0 / page;                   // the install's table page
    const int t_pid = tj >= 0 && tj < m ? ptab_row[tj] : -1;
    int q_pos[RW];                              // each row's position
#pragma unroll
    for (int r = 0; r < RW; ++r) q_pos[r] = p0 + (wrow0 + r) % c;
    const int n_h = key1 - key0;
    const int n_run = n_h + (last ? c : 0);
    const int n_kc = (dh + FB - 1) / FB;        // K slabs a tile

    // the first tile at or after v0 (of the run) holding a live key: lane
    // t's key row (in the pool, or in k_new/v_new for a chunk key) and
    // whether it is live; present = the live lanes.  Every warp finds the
    // same tiles (the block's control flow stays uniform)
    struct Tile {
        int v0;
        size_t off;
        bool has, chunk;
        unsigned present;
    };
    auto find = [&](int v0) {
        for (; v0 < n_run; v0 += TILE) {
            const int v = v0 + lane;
            bool has = false, chunk = false;
            size_t off = 0;
            if (v < n_h) {
                const int key = key0 + v;
                const int j = key / page;
                has = page_live(j, page, p0, c, true, window, sinks);
                if (has) {
                    const int pid = v0 == 0 ? pid0 : ptab_row[j];
                    off = (((size_t)pid * kv + kvh) * page + (key - j * page))
                          * dh;
                }
            } else if (v < n_run) {
                has = chunk = true;
                off = chunk_kv + (size_t)(v - n_h) * dh;
            }
            const unsigned present = __ballot_sync(FULL, has);
            if (present) return Tile{v0, off, has, chunk, present};
        }
        return Tile{n_run, 0, false, false, 0u};
    };
    // slab sidx of tile tl into dst: K columns [sidx FB, +FB) for sidx <
    // n_kc, else V columns [f0, f0 + FB); zero outside the live rows and
    // dh.  Thread x copies piece x, x + blockDim.x, ...: row r's source
    // from lane r of the copying warp (every warp holds the whole tile)
    auto stage = [&](const Tile& tl, int sidx, float* dst) {
        const bool kslab = sidx < n_kc;
        const int col0 = kslab ? sidx * FB : f0;
        const int n_pc = FB / width;            // pieces a row
        for (int x = threadIdx.x; x < TILE * n_pc; x += blockDim.x) {
            const int r = x / n_pc, cc = (x - r * n_pc) * width;
            const size_t off = __shfl_sync(FULL, tl.off, r);
            const bool chunk = __shfl_sync(FULL, tl.chunk, r);
            const bool in = __shfl_sync(FULL, tl.has, r) && col0 + cc < dh;
            const float* base = kslab ? (chunk ? k_new : k_pool)
                                      : (chunk ? v_new : v_pool);
            const float* src = in ? base + off + col0 + cc : base;
            if (VEC) cp_async16(dst + r * ld + cc, src, in);
            else cp_async4(dst + r * ld + cc, src, in);
        }
    };

    float m_r[RW], l_r[RW], acc[RW][E], s[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
        m_r[r] = NEG_INF;
        l_r[r] = 0.f;                          // this lane's share of l
#pragma unroll
        for (int u = 0; u < E; ++u) acc[r][u] = 0.f;
    }

    // two slabs in flight ahead of the one in use: the first tile's
    // first two (K and V when dh fits one K slab) go out at once
    Tile cur = find(0), nxt = cur;
    if (cur.present) {
        stage(cur, 0, smem);
        cp_commit();
        stage(cur, 1, smem + TILE * ld);
        cp_commit();
        nxt = find(cur.v0 + TILE);
    }
    float* p_w = p_s + warp * RW * TILE;        // this warp's rows of p
    int buf = 0;                                // ring slot in use
    while (cur.present) {
#pragma unroll
        for (int r = 0; r < RW; ++r) s[r] = 0.f;
        for (int sidx = 0; sidx <= n_kc; ++sidx, buf = buf == 2 ? 0 : buf + 1) {
            // the slab two ahead (this tile's, else the next tile's) into
            // the slot freed by the slab before this one; a group per
            // step, empty past the last slab, so that two stay in flight
            const bool vslab = sidx == n_kc;
            float* ahead = smem + (buf == 0 ? 2 : buf - 1) * TILE * ld;
            if (sidx + 2 <= n_kc) stage(cur, sidx + 2, ahead);
            else if (nxt.present) stage(nxt, sidx + 1 - n_kc, ahead);
            cp_commit();
            cp_wait<2>();
            __syncthreads();
            const float* sl = smem + buf * TILE * ld;
            if (!vslab) {
                // scores: lane t's key row against each of the warp's
                // rows, over this slab's head columns
                const float* kr = sl + lane * ld;
                const float* qr = q_s + (size_t)warp * RW * dh + sidx * FB;
                const int w = min(FB, dh - sidx * FB);
                if (VEC) {
#pragma unroll 1
                    for (int e4 = 0; e4 < w / 4; ++e4) {
                        const float4 k4 =
                            reinterpret_cast<const float4*>(kr)[e4];
#pragma unroll
                        for (int r = 0; r < RW; ++r) {
                            const float4 q4 = reinterpret_cast<const float4*>(
                                qr + r * dh)[e4];
                            s[r] += q4.x * k4.x;
                            s[r] += q4.y * k4.y;
                            s[r] += q4.z * k4.z;
                            s[r] += q4.w * k4.w;
                        }
                    }
                } else {
                    for (int e = 0; e < w; ++e) {
                        const float kx = kr[e];
#pragma unroll
                        for (int r = 0; r < RW; ++r)
                            s[r] += qr[r * dh + e] * kx;
                    }
                }
            } else {
                // P.V: four keys' V rows at a time, lane e holding
                // features e, e+32, ... (absent keys have p = 0 and zero
                // rows)
#pragma unroll 1
                for (int t4 = 0; t4 < TILE / 4; ++t4) {
                    float v[4][E];
#pragma unroll
                    for (int tt = 0; tt < 4; ++tt)
#pragma unroll
                        for (int u = 0; u < E; ++u)
                            v[tt][u] = sl[(4 * t4 + tt) * ld + lane + 32 * u];
#pragma unroll
                    for (int r = 0; r < RW; ++r) {
                        const float4 p4 =
                            reinterpret_cast<const float4*>(p_w + r * TILE)[t4];
#pragma unroll
                        for (int u = 0; u < E; ++u) {
                            acc[r][u] += p4.x * v[0][u];
                            acc[r][u] += p4.y * v[1][u];
                            acc[r][u] += p4.z * v[2][u];
                            acc[r][u] += p4.w * v[3][u];
                        }
                    }
                }
            }
            if (sidx == n_kc - 1) {
                // online softmax: fold the tile into each row's (m, l,
                // acc); lane t's key at its position in the sequence.  The
                // rows' max reductions go step by step together, so their
                // shuffles overlap
                const int v = cur.v0 + lane;
                const int kpos = cur.chunk ? p0 + (v - n_h) : key0 + v;
                float sr[RW], mx[RW];
#pragma unroll
                for (int r = 0; r < RW; ++r) {
                    const bool live = band_live(kpos, q_pos[r], p0,
                                                !cur.chunk, window, sinks);
                    sr[r] = cur.has ? s[r] * inv_scale + (live ? 0.f : NEG_INF)
                                    : -INFINITY;
                    mx[r] = sr[r];
                }
#pragma unroll
                for (int o = 16; o > 0; o >>= 1)
#pragma unroll
                    for (int r = 0; r < RW; ++r)
                        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], o));
#pragma unroll
                for (int r = 0; r < RW; ++r) {
                    const float m_new = fmaxf(m_r[r], mx[r]);
                    const float alpha = expf(m_r[r] - m_new);
                    const float p = expf(sr[r] - m_new);   // 0 if absent
                    l_r[r] = l_r[r] * alpha + p;
                    m_r[r] = m_new;
#pragma unroll
                    for (int u = 0; u < E; ++u) acc[r][u] *= alpha;
                    p_w[r * TILE + lane] = p;
                }
            }
            __syncthreads();
        }
        cur = nxt;
        if (cur.present) nxt = find(cur.v0 + TILE);
    }

    cp_wait<0>();                               // the query rows, if unused

    // the split's state: o itself when there is one split, else (m, l)
    // and acc in the workspace; a split with no live key writes m =
    // NEG_INF, l = 0, acc = 0, which the combine weighs exp(NEG_INF - M)
    // == 0
    float* ws_acc = ws + (size_t)2 * gridDim.x * kv * rows * splits;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)            // the rows' l, together
#pragma unroll
        for (int r = 0; r < RW; ++r) l_r[r] += __shfl_xor_sync(FULL, l_r[r], o);
#pragma unroll
    for (int r = 0; r < RW; ++r) {
        const int row = wrow0 + r;
        if (row >= rows) break;
        const float l_w = l_r[r];
        const int head = kvh * g + row / c;
        const size_t state = (((size_t)i * kv + kvh) * rows + row) * splits
                             + split;
        if (splits > 1 && f0 == 0 && lane == 0) {
            ws[2 * state] = m_r[r];
            ws[2 * state + 1] = l_w;
        }
#pragma unroll
        for (int u = 0; u < E; ++u) {
            const int e = lane + 32 * u;
            if (e >= nf) continue;
            if (splits == 1)
                o[(((size_t)i * h + head) * c + row % c) * dh + f0 + e] =
                    acc[r][u] / l_w;
            else
                ws_acc[state * dh + f0 + e] = acc[r][u];
        }
    }

    // the install's stores: the piece read at entry, then the rest of the
    // slice (when it is longer than the block)
    if (t_pid >= 0) {
        float* k_dst = k_pool + ((size_t)t_pid * kv + kvh) * (size_t)page * dh;
        float* v_dst = v_pool + ((size_t)t_pid * kv + kvh) * (size_t)page * dh;
        for (size_t x = inst0; x < inst1; x += blockDim.x) {
            const bool first = x == inst0;
            if (VEC) {
                reinterpret_cast<float4*>(k_dst)[x] = first
                    ? *reinterpret_cast<const float4*>(k_in)
                    : reinterpret_cast<const float4*>(k_new + chunk_kv)[x];
                reinterpret_cast<float4*>(v_dst)[x] = first
                    ? *reinterpret_cast<const float4*>(v_in)
                    : reinterpret_cast<const float4*>(v_new + chunk_kv)[x];
            } else {
                k_dst[x] = first ? *k_in : k_new[chunk_kv + x];
                v_dst[x] = first ? *v_in : v_new[chunk_kv + x];
            }
        }
    }
}

// combine_kernel after a split kernel on the same stream, by programmatic
// dependent launch (it starts while the split kernel runs and waits inside).
int launch_combine(const float* ws, float* o, int b, int h, int kv, int c,
                   int dh, int splits, void* stream) {
    const size_t n = (size_t)b * h * c * dh;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)((n + 255) / 256));
    cfg.blockDim = dim3(256);
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return (int)cudaLaunchKernelEx(&cfg, combine_kernel, ws, o, b, h, kv, c,
                                   dh, splits);
}

// The decode launch's row and feature blocks: R query rows a block (1 for
// plain decode without GQA, g c == 1, else 4) and 32 E features, E the
// fewest registers that cover dh (feature blocks of 256 above that).
struct DecodeShape {
    int r, e, row_blocks, feature_blocks;
};

DecodeShape decode_shape(int h, int kv, int c, int dh) {
    const int rows = (h / kv) * c;
    const int r = rows == 1 ? 1 : 4;
    const int e = dh <= 64 ? 2 : dh <= 128 ? 4 : 8;
    return {r, e, (rows + r - 1) / r, (dh + 32 * e - 1) / (32 * e)};
}

// Warps that fill the card: 4 an SM on the H100's 132 SMs.
constexpr long kDecodeWarps = 132 * 4;

template <int R, int E>
int launch_decode(const float* q, const float* k_pool, const float* v_pool,
                  const int* ptab, const int* pos, float* o, float* ws,
                  int b, int h, int kv, int c, int dh, int page, int m,
                  int window, int sinks, int splits, int vec,
                  void* stream) {
    const DecodeShape ds = decode_shape(h, kv, c, dh);
    const int ld = vec ? 32 * E + 4 : 32 * E + 1;
    const size_t smem = sizeof(float) * ((size_t)2 * TILE * ld
                                         + (size_t)R * dh);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            decode_split_kernel<R, E>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    dim3 grid(b, kv, ds.row_blocks * ds.feature_blocks * splits);
    decode_split_kernel<R, E><<<grid, 32, smem, (cudaStream_t)stream>>>(
        q, k_pool, v_pool, ptab, pos, o, ws, h, kv, c, dh, page, m, window,
        sinks, ds.row_blocks, splits, vec);
    int code = (int)cudaGetLastError();
    if (code || splits == 1) return code;
    return launch_combine(ws, o, b, h, kv, c, dh, splits, stream);
}


// The prefill launch's tile: 8 warps of RW rows each (a tile of 8 RW
// rows: the fewest that cover the kv head's g c rows, up to 64) and 32 E
// features (E 2 up to head_dim 64, else 4, feature blocks of 128 above
// that).  The shared memory (three slabs, the tile's p and its query rows)
// must fit a block: a head too wide for it takes fewer warps, then fewer
// rows a warp.
struct PrefillShape {
    int rw, nw, e, row_tiles, feature_blocks;
    size_t smem;
};

constexpr size_t kMaxSmem = 227 * 1024;

size_t prefill_smem(int nw, int rw, int e, int dh) {
    // slab rows sized for the 16-byte path, which the 4-byte path fits;
    // the install's first piece a thread, a float4 of K and of V
    const size_t rt = (size_t)nw * rw;
    return sizeof(float) * ((size_t)3 * TILE * (32 * e + 4) + rt * TILE
                            + rt * dh + (size_t)2 * 4 * 32 * nw);
}

PrefillShape prefill_shape(int h, int kv, int c, int dh) {
    const int rows = (h / kv) * c;
    const int e = dh <= 64 ? 2 : 4;
    int nw = 8, rw = 8;
    while (rw > 1 && nw * rw / 2 >= rows) rw /= 2;
    while (prefill_smem(nw, rw, e, dh) > kMaxSmem && nw * rw > 1) {
        if (nw > 1) nw /= 2;
        else rw /= 2;
    }
    return {rw, nw, e, (rows + nw * rw - 1) / (nw * rw),
            (dh + 32 * e - 1) / (32 * e), prefill_smem(nw, rw, e, dh)};
}

// Blocks that fill the card: 2 an SM on the H100's 132 SMs.
constexpr long kPrefillBlocks = 132 * 2;

template <int RW, int E, bool VEC>
int launch_prefill(const float* q, const float* k_new, const float* v_new,
                   float* k_pool, float* v_pool, const int* ptab,
                   const int* pos, float* o, float* ws, int b, int h, int kv,
                   int c, int dh, int page, int m, int window, int sinks,
                   int splits, const PrefillShape& ps, void* stream) {
    if (ps.smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            prefill_split_kernel<RW, E, VEC>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ps.smem);
        if (err != cudaSuccess) return (int)err;
    }
    dim3 grid(b, kv, ps.row_tiles * ps.feature_blocks * splits);
    prefill_split_kernel<RW, E, VEC>
        <<<grid, ps.nw * 32, ps.smem, (cudaStream_t)stream>>>(
            q, k_new, v_new, k_pool, v_pool, ptab, pos, o, ws, h, kv, c, dh,
            page, m, window, sinks, ps.row_tiles, splits);
    int code = (int)cudaGetLastError();
    if (code || splits == 1) return code;
    return launch_combine(ws, o, b, h, kv, c, dh, splits, stream);
}

}  // namespace

extern "C" {

int paged_flash_decode_splits(int b, int h, int kv, int c, int dh, int m) {
    if (b < 1 || kv < 1 || h < kv || c < 1 || dh < 1 || m < 1) return 1;
    const DecodeShape ds = decode_shape(h, kv, c, dh);
    const long blocks = (long)b * kv * ds.row_blocks * ds.feature_blocks;
    long want = (kDecodeWarps + blocks - 1) / blocks;
    want = std::max(1L, std::min(want, 65535L / (ds.row_blocks
                                                 * ds.feature_blocks)));
    // as many splits as there are ranges of ceil(m / want) pages
    const long per = (m + std::min(want, (long)m) - 1)
                     / std::min(want, (long)m);
    return (int)((m + per - 1) / per);
}

// Dynamic shared memory of a decode block (16-byte copies when dh % 4 == 0).
int paged_flash_decode_smem_bytes(int h, int kv, int c, int dh) {
    const DecodeShape ds = decode_shape(h, kv, c, dh);
    const int ld = dh % 4 == 0 ? 32 * ds.e + 4 : 32 * ds.e + 1;
    return (int)(sizeof(float) * (2 * TILE * ld + ds.r * dh));
}

int paged_flash_decode_f32(const float* q, const float* k_pool,
                           const float* v_pool, const int* ptab,
                           const int* pos, float* o, float* workspace,
                           int b, int h, int kv, int c, int dh, int page,
                           int m, int window, int sinks, int splits,
                           void* stream) {
    if (splits < 1 || (splits > 1 && !workspace))
        return (int)cudaErrorInvalidValue;
    // 16-byte copies: rows of whole float4s and 16-byte aligned pools
    const int vec = dh % 4 == 0 && (uintptr_t)k_pool % 16 == 0
                    && (uintptr_t)v_pool % 16 == 0;
    const DecodeShape ds = decode_shape(h, kv, c, dh);
#define PFD_LAUNCH(R, E)                                                  \
    return launch_decode<R, E>(q, k_pool, v_pool, ptab, pos, o, workspace, \
                               b, h, kv, c, dh, page, m, window, sinks,   \
                               splits, vec, stream)
    if (ds.r == 1) {
        if (ds.e == 2) PFD_LAUNCH(1, 2);
        if (ds.e == 4) PFD_LAUNCH(1, 4);
        PFD_LAUNCH(1, 8);
    }
    if (ds.e == 2) PFD_LAUNCH(4, 2);
    if (ds.e == 4) PFD_LAUNCH(4, 4);
    PFD_LAUNCH(4, 8);
#undef PFD_LAUNCH
}

// How many ranges of a lane's table the prefill splits its walk into: enough
// blocks to fill the card, each split at least one page (from the geometry
// alone; pos stays on the card).
int paged_flash_prefill_splits(int b, int h, int kv, int c, int dh, int m) {
    if (b < 1 || kv < 1 || h < kv || c < 1 || dh < 1 || m < 1) return 1;
    const PrefillShape ps = prefill_shape(h, kv, c, dh);
    const long tiles = (long)ps.row_tiles * ps.feature_blocks;
    long want = (kPrefillBlocks + b * kv * tiles - 1) / (b * kv * tiles);
    want = std::max(1L, std::min({want, 65535L / tiles, (long)m}));
    // as many splits as there are ranges of ceil(m / want) pages
    const long per = (m + want - 1) / want;
    return (int)((m + per - 1) / per);
}

// Dynamic shared memory of a prefill block.
int paged_flash_prefill_smem_bytes(int h, int kv, int c, int dh) {
    return (int)prefill_shape(h, kv, c, dh).smem;
}

// Attention of one page-aligned chunk (c == page) per lane over its history
// and itself, and the chunk's K/V installed into its pool page.  workspace
// holds b h c splits (dh + 2) floats, splits =
// paged_flash_prefill_splits(b, h, kv, c, dh, m); it may be null when that
// is 1.
int paged_flash_prefill_f32(const float* q, const float* k_new,
                            const float* v_new, float* k_pool,
                            float* v_pool, const int* ptab, const int* pos,
                            float* o, float* workspace, int b, int h, int kv,
                            int c, int dh, int page, int m, int window,
                            int sinks, void* stream) {
    if (c != page) return (int)cudaErrorInvalidValue;
    const int splits = paged_flash_prefill_splits(b, h, kv, c, dh, m);
    if (splits > 1 && !workspace) return (int)cudaErrorInvalidValue;
    // 16-byte copies: rows of whole float4s and 16-byte aligned operands
    const int vec = dh % 4 == 0
        && ((uintptr_t)q | (uintptr_t)k_new | (uintptr_t)v_new
            | (uintptr_t)k_pool | (uintptr_t)v_pool) % 16 == 0;
    const PrefillShape ps = prefill_shape(h, kv, c, dh);
#define PFP_LAUNCH(RW, E)                                                 \
    return vec ? launch_prefill<RW, E, true>(                             \
                     q, k_new, v_new, k_pool, v_pool, ptab, pos, o,       \
                     workspace, b, h, kv, c, dh, page, m, window, sinks,  \
                     splits, ps, stream)                                  \
               : launch_prefill<RW, E, false>(                            \
                     q, k_new, v_new, k_pool, v_pool, ptab, pos, o,       \
                     workspace, b, h, kv, c, dh, page, m, window, sinks,  \
                     splits, ps, stream)
#define PFP_ROWS(E)                                                       \
    if (ps.rw == 8) PFP_LAUNCH(8, E);                                     \
    if (ps.rw == 4) PFP_LAUNCH(4, E);                                     \
    if (ps.rw == 2) PFP_LAUNCH(2, E);                                     \
    PFP_LAUNCH(1, E)
    if (ps.e == 2) {
        PFP_ROWS(2);
    }
    PFP_ROWS(4);
#undef PFP_ROWS
#undef PFP_LAUNCH
}

const char* paged_flash_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
