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
// Prefill (paged_flash_kernel<true, R, E>; simple first, wgmma/TMA later):
//   grid  (b, kv, n_row_blocks * n_feature_blocks), block WARPS warps;
//   a block owns R query rows of kv head j (R = 1 when g*c == 1, else
//   4): row r is query head j*g + r / c at chunk offset
//   r % c (the reference's GQA fold, equal to jnp.repeat's head
//   mapping), and 32*E output features (feature blocks only split a
//   head_dim above 256, each block recomputing the full-width scores);
//   the lane's keys — its table's history, then the chunk —
//   are walked in tiles of 32, tile w, w + WARPS, ... by warp w: lane t
//   scores key t of the tile against the R rows (the key row read
//   straight from device memory), the warp folds the tile into its
//   running max m, sum l and accumulator acc per row (the online
//   softmax of the reference's _flash_step), then accumulates P.V with
//   lane e holding output features e, e+32, ... of coalesced V rows;
//   at the end the warps' (m, l, acc) meet in shared memory.
//   Nothing in the block grows with the table width: there is no score
//   row, so max_len is bounded only by the pool.  (The template's decode
//   branches, PREFILL false, are no longer instantiated.)
//
// Masking follows the reference exactly: NEG_INF is finite (-1e30) and
// ADDED to the scaled score s = (q.k) / sqrt(dh), so a row's masked
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

constexpr int WARPS = 16;
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

template <bool PREFILL, int R, int E>
__global__ void __launch_bounds__(WARPS * 32)
paged_flash_kernel(const float* __restrict__ q,
                   const float* __restrict__ k_new,
                   const float* __restrict__ v_new,
                   float* k_pool, float* v_pool,
                   const int* __restrict__ ptab,
                   const int* __restrict__ pos,
                   float* __restrict__ o,
                   int h, int kv, int c, int dh, int page, int m,
                   int window, int sinks, int n_row_blocks) {
    constexpr int FB = 32 * E;                  // features of one block
    extern __shared__ __align__(16) float smem[];
    float* q_s = smem;                          // R * dh
    float* acc_s = q_s + R * dh;                // WARPS * R * FB
    float* m_s = acc_s + WARPS * R * FB;        // WARPS * R
    float* l_s = m_s + WARPS * R;               // WARPS * R

    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int i = blockIdx.x;
    const int kvh = blockIdx.y;
    const int g = h / kv;
    const int row0 = (blockIdx.z % n_row_blocks) * R;
    const int f0 = (blockIdx.z / n_row_blocks) * FB;
    const int nrows = min(R, g * c - row0);
    const int nf = min(FB, dh - f0);
    const int p0 = pos[i];
    const float scale = sqrtf((float)dh);
    const int* ptab_row = ptab + (size_t)i * m;
    const size_t tile_elems = (size_t)page * dh;
    const size_t lane_kv = ((size_t)i * kv + kvh) * tile_elems;

    for (int x = threadIdx.x; x < R * dh; x += blockDim.x) {
        const int r = x / dh, e = x - r * dh;
        float v = 0.f;
        if (r < nrows) {
            const int row = row0 + r;
            const int head = kvh * g + row / c;
            v = q[(((size_t)i * h + head) * c + row % c) * dh + e];
        }
        q_s[x] = v;
    }
    __syncthreads();

    // the lane's keys: history columns [0, n_hist) of its table view,
    // then (prefill) the chunk's c keys; the history stops at the last
    // page that can hold a key at or below the lane's last query
    const int n_hist = PREFILL
        ? min(m * page, p0)
        : min(m, (p0 + c - 1) / page + 1) * page;
    const int n_keys = n_hist + (PREFILL ? c : 0);
    const bool vec = (dh & 3) == 0;

    float m_r[R], l_r[R], acc[R][E];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        m_r[r] = NEG_INF;
        l_r[r] = 0.f;                          // this lane's share of l
#pragma unroll
        for (int u = 0; u < E; ++u) acc[r][u] = 0.f;
    }

    for (int k0 = warp * TILE; k0 < n_keys; k0 += WARPS * TILE) {
        // lane t's key: its pool (or chunk) row, position and band base
        const int key = k0 + lane;
        const bool chunk = PREFILL && key >= n_hist;
        bool has = key < n_keys;
        size_t off = 0;
        int kpos = key;
        if (has) {
            if (chunk) {
                off = lane_kv + (size_t)(key - n_hist) * dh;
                kpos = p0 + (key - n_hist);
            } else {
                const int j = key / page;
                has = page_live(j, page, p0, c, PREFILL, window, sinks);
                off = (((size_t)ptab_row[j] * kv + kvh) * page
                       + (key - j * page)) * dh;
            }
        }
        const unsigned present = __ballot_sync(FULL, has);
        if (!present) continue;

        // scores: lane t dots key t's full row with each query row
        float s[R];
#pragma unroll
        for (int r = 0; r < R; ++r) s[r] = 0.f;
        if (has) {
            const float* kr = (chunk ? k_new : k_pool) + off;
            if (vec) {
#pragma unroll 8
                for (int e4 = 0; e4 < dh / 4; ++e4) {
                    const float4 k4 =
                        __ldg(reinterpret_cast<const float4*>(kr) + e4);
#pragma unroll
                    for (int r = 0; r < R; ++r) {
                        const float4 q4 = reinterpret_cast<const float4*>(
                            q_s + r * dh)[e4];
                        s[r] += q4.x * k4.x;
                        s[r] += q4.y * k4.y;
                        s[r] += q4.z * k4.z;
                        s[r] += q4.w * k4.w;
                    }
                }
            } else {
                for (int e = 0; e < dh; ++e) {
                    const float kx = __ldg(kr + e);
#pragma unroll
                    for (int r = 0; r < R; ++r) s[r] += q_s[r * dh + e] * kx;
                }
            }
        }

        // online softmax: fold the tile into each row's (m, l, acc)
        float p[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int q_pos = p0 + (row0 + r) % c;
            const float sr = has
                ? s[r] / scale + (band_live(kpos, q_pos, p0,
                                            PREFILL && !chunk, window,
                                            sinks) ? 0.f : NEG_INF)
                : -INFINITY;
            const float m_new = fmaxf(m_r[r], warp_max(sr));
            const float alpha = expf(m_r[r] - m_new);
            p[r] = expf(sr - m_new);           // 0 for an absent key
            l_r[r] = l_r[r] * alpha + p[r];
            m_r[r] = m_new;
#pragma unroll
            for (int u = 0; u < E; ++u) acc[r][u] *= alpha;
        }

        // P.V: key t's V row, coalesced over the lanes' features
        // (predicated rather than branched, so the unrolled keys' loads
        // are in flight together)
#pragma unroll 8
        for (int t = 0; t < TILE; ++t) {
            const bool live_t = (present >> t) & 1u;
            const size_t off_t = __shfl_sync(FULL, off, t);
            const bool chunk_t = PREFILL && k0 + t >= n_hist;
            const float* vr = (chunk_t ? v_new : v_pool) + off_t + f0;
            float v[E];
#pragma unroll
            for (int u = 0; u < E; ++u) {
                const int e = lane + 32 * u;
                v[u] = live_t && e < nf ? __ldg(vr + e) : 0.f;
            }
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const float pt = __shfl_sync(FULL, p[r], t);
#pragma unroll
                for (int u = 0; u < E; ++u) acc[r][u] += pt * v[u];
            }
        }
    }

    // the warps' states meet: o = sum_w acc_w e^(m_w - M) /
    // sum_w l_w e^(m_w - M); a warp that saw no live key of a row holds
    // m_w = NEG_INF and weighs exp(-1e30 - M) == 0
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const float l_w = warp_sum(l_r[r]);
        if (lane == 0) {
            m_s[warp * R + r] = m_r[r];
            l_s[warp * R + r] = l_w;
        }
#pragma unroll
        for (int u = 0; u < E; ++u) {
            const int e = lane + 32 * u;
            if (e < nf) acc_s[(warp * R + r) * FB + e] = acc[r][u];
        }
    }
    __syncthreads();
    for (int x = threadIdx.x; x < nrows * nf; x += blockDim.x) {
        const int r = x / nf, e = x - r * nf;
        float mx = NEG_INF;
        for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, m_s[w * R + r]);
        float num = 0.f, den = 0.f;
        for (int w = 0; w < WARPS; ++w) {
            const float a = expf(m_s[w * R + r] - mx);
            num += acc_s[(w * R + r) * FB + e] * a;
            den += l_s[w * R + r] * a;
        }
        const int row = row0 + r;
        const int head = kvh * g + row / c;
        o[(((size_t)i * h + head) * c + row % c) * dh + f0 + e] = num / den;
    }

    if (PREFILL && blockIdx.z == 0) {
        // fused install: the chunk's rows land in the lane's target
        // page.  No block reads that page: its keys all sit at or past
        // the frontier, outside the history walk.
        const int tj = p0 / page;
        if (tj >= 0 && tj < m) {
            const size_t dst = ((size_t)ptab_row[tj] * kv + kvh)
                * tile_elems;
            for (size_t x = threadIdx.x; x < tile_elems; x += blockDim.x) {
                k_pool[dst + x] = k_new[lane_kv + x];
                v_pool[dst + x] = v_new[lane_kv + x];
            }
        }
    }
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
// largest m_s.  One thread an output element.
__global__ void __launch_bounds__(256)
combine_kernel(const float* __restrict__ ws, float* __restrict__ o, int b,
               int h, int kv, int c, int dh, int splits) {
    grid_dependency_wait();
    const int rows = (h / kv) * c;
    const size_t n = (size_t)b * kv * rows * dh;
    const size_t x = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (x >= n) return;
    const size_t st = x / dh;                   // (lane, kv head, row)
    const int e = (int)(x - st * dh);
    const float* ml = ws + 2 * st * splits;
    const float* acc = ws + 2 * n / dh * splits + st * splits * dh + e;
    // unrolled, so that each pass's reads are in flight together
    float mx = NEG_INF;
#pragma unroll 8
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ml[2 * s]);
    float num = 0.f, den = 0.f;
#pragma unroll 8
    for (int s = 0; s < splits; ++s) {
        const float a = expf(ml[2 * s] - mx);
        num += acc[(size_t)s * dh] * a;
        den += ml[2 * s + 1] * a;
    }
    const int row = (int)(st % rows);
    const size_t lk = st / rows;                // lane * kv + kv head
    const int kvh = (int)(lk % kv), i = (int)(lk / kv);
    const int head = kvh * (h / kv) + row / c;
    o[(((size_t)i * h + head) * c + row % c) * dh + e] = num / den;
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
    return (int)cudaLaunchKernelEx(&cfg, combine_kernel, (const float*)ws, o,
                                   b, h, kv, c, dh, splits);
}

template <bool PREFILL, int R, int E>
int launch_rows(const float* q, const float* k_new, const float* v_new,
                float* k_pool, float* v_pool, const int* ptab,
                const int* pos, float* o, int b, int h, int kv, int c,
                int dh, int page, int m, int window, int sinks,
                void* stream) {
    // shared memory: R query rows, then each warp's acc, m and l
    const size_t smem = sizeof(float)
        * ((size_t)R * dh + (size_t)WARPS * R * (32 * E + 2));
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            paged_flash_kernel<PREFILL, R, E>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const int n_row_blocks = ((h / kv) * c + R - 1) / R;
    const int n_feature_blocks = (dh + 32 * E - 1) / (32 * E);
    dim3 grid(b, kv, n_row_blocks * n_feature_blocks);
    paged_flash_kernel<PREFILL, R, E>
        <<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(
            q, k_new, v_new, k_pool, v_pool, ptab, pos, o, h, kv, c, dh,
            page, m, window, sinks, n_row_blocks);
    return (int)cudaGetLastError();
}

// One query row per block when the lane's kv head serves exactly one
// (plain decode without GQA), else four; the fewest output registers
// that cover dh (feature blocks of 256 above that).
template <bool PREFILL>
int launch(const float* q, const float* k_new, const float* v_new,
           float* k_pool, float* v_pool, const int* ptab, const int* pos,
           float* o, int b, int h, int kv, int c, int dh, int page, int m,
           int window, int sinks, void* stream) {
#define PFA_LAUNCH(R, E)                                                  \
    return launch_rows<PREFILL, R, E>(q, k_new, v_new, k_pool, v_pool,    \
                                      ptab, pos, o, b, h, kv, c, dh,      \
                                      page, m, window, sinks, stream)
    const bool one = (h / kv) * c == 1;
    if (dh <= 64) {
        if (one) PFA_LAUNCH(1, 2);
        PFA_LAUNCH(4, 2);
    }
    if (dh <= 128) {
        if (one) PFA_LAUNCH(1, 4);
        PFA_LAUNCH(4, 4);
    }
    if (one) PFA_LAUNCH(1, 8);
    PFA_LAUNCH(4, 8);
#undef PFA_LAUNCH
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

int paged_flash_prefill_f32(const float* q, const float* k_new,
                            const float* v_new, float* k_pool,
                            float* v_pool, const int* ptab, const int* pos,
                            float* o, int b, int h, int kv, int c, int dh,
                            int page, int m, int window, int sinks,
                            void* stream) {
    return launch<true>(q, k_new, v_new, k_pool, v_pool, ptab, pos, o, b,
                        h, kv, c, dh, page, m, window, sinks, stream);
}

const char* paged_flash_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
