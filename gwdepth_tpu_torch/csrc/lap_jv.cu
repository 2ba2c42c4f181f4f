// Rectangular linear assignment by the Jonker-Volgenant shortest
// augmenting path, every problem of a call in one launch.
//
// Replaces gwdepth_tpu/ops/lap.py:105 `hungarian_rect` (with
// `match_lines(backend="jax")` around it), which the JAX package runs on
// the device as a `lax.while_loop`, vmapped over every (decoder layer,
// image) problem of a train step: an XLA loop, not a Pallas kernel.
// Problem p has the (Q, T) cost cost[p] (query q, target slot t) and
// n_valid[p] real targets; its rows t < n_valid (targets) are assigned to
// distinct columns q (queries), one augmenting path a row, and
// out[p, t] is the query of slot t, 0 for t >= n_valid as JAX clips it.
//
// Arithmetic: float32 in JAX's order, r = ((minval + cost[i]) - u[i]) -
// v, with round-to-nearest intrinsics so that nothing is contracted; the
// dual updates of JAX (scipy's rectangular_lsap.cpp); the argmin takes
// the lowest column on ties, as jnp.argmin. So the assignment equals the
// JAX solver's, and the plain version's (`ops/lap.py:hungarian_rect`),
// bit for bit on the same float32 cost.
//
// Bound: the serial chain of Dijkstra steps (one scanned column each) and
// augment steps, not bytes or operations: a problem reads its n_valid
// cost rows (38 KB at Q = 100, T = 96) and does ~5 flops a column a step.
// Design: one block of one warp per problem, so the problems run side by
// side on separate SMs and a step's only synchronisation is the warp's.
// u, v, spc, path, SR, SC, col4row and row4col live in shared memory. In
// a Dijkstra step each lane updates its columns j = lane + 32 k (4 at
// Q = 100) and keeps its lowest (value, column); a butterfly of shuffles
// then gives every lane the lowest value at the lowest column. The
// augment walk is serial, on lane 0. The cost stays in device memory
// (read through the read-only cache; a problem's rows fit in L1).
//
// Non-finite costs: with finite costs a row's Dijkstra search ends within
// Q steps and its augment walk within T. Where NaN or infinite costs
// would send JAX's loops round forever, the caps stop the problem
// instead: its remaining rows keep query 0. The plain version stops at
// the same places.

#include <cuda_runtime.h>

namespace {

constexpr float kInf = 1e30f;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(32)
lap_jv_kernel(const float* __restrict__ cost,
              const long long* __restrict__ n_valid,
              long long* __restrict__ out, int Q, int T) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* u = reinterpret_cast<float*>(smem);
    float* v = u + T;
    float* spc = v + Q;
    int* path = reinterpret_cast<int*>(spc + Q);
    int* col4row = path + Q;
    int* row4col = col4row + T;
    unsigned char* SR = reinterpret_cast<unsigned char*>(row4col + Q);
    unsigned char* SC = SR + T;

    const int lane = threadIdx.x;
    const long long p = blockIdx.x;
    const float* C = cost + p * static_cast<long long>(Q) * T;  // C[q*T+t]
    const long long nv_in = n_valid[p];
    const int nv = nv_in < 0 ? 0 : (nv_in > T ? T : static_cast<int>(nv_in));

    for (int t = lane; t < T; t += 32) {
        u[t] = 0.f;
        col4row[t] = -1;
    }
    for (int j = lane; j < Q; j += 32) {
        v[j] = 0.f;
        row4col[j] = -1;
    }
    __syncwarp();

    for (int cur = 0; cur < nv; ++cur) {
        for (int t = lane; t < T; t += 32) SR[t] = 0;
        for (int j = lane; j < Q; j += 32) {
            SC[j] = 0;
            spc[j] = kInf;
            path[j] = 0;
        }
        __syncwarp();

        // Dijkstra over the columns for the shortest augmenting path
        int i = cur, sink = -1;
        float minval = 0.f;
        for (int step = 0; step < Q && sink < 0; ++step) {
            if (lane == 0) SR[i] = 1;
            const float ui = u[i];
            float bv = kInf;
            int bj = -1;
            for (int j = lane; j < Q; j += 32) {
                float m = kInf;
                if (!SC[j]) {
                    const float c = __ldg(C + static_cast<long long>(j) * T + i);
                    const float r =
                        __fsub_rn(__fsub_rn(__fadd_rn(minval, c), ui), v[j]);
                    float s = spc[j];
                    if (r < s) {
                        s = r;
                        spc[j] = r;
                        path[j] = i;
                    }
                    m = s;
                }
                if (bj < 0 || m < bv) {
                    bv = m;
                    bj = j;
                }
            }
            for (int off = 16; off > 0; off >>= 1) {
                const float ov = __shfl_xor_sync(kFull, bv, off);
                const int oj = __shfl_xor_sync(kFull, bj, off);
                if (oj >= 0 &&
                    (bj < 0 || ov < bv || (ov == bv && oj < bj))) {
                    bv = ov;
                    bj = oj;
                }
            }
            minval = bv;
            const int nxt = row4col[bj];
            __syncwarp();
            if (lane == 0) SC[bj] = 1;
            __syncwarp();
            if (nxt < 0)
                sink = bj;
            else
                i = nxt;
        }
        if (sink < 0) break;   // non-finite costs: stop this problem

        // dual updates (scipy rectangular_lsap.cpp semantics, JAX's order)
        for (int t = lane; t < T; t += 32) {
            if (t == cur) {
                u[t] = __fadd_rn(u[t], minval);
            } else if (SR[t]) {
                const int c = col4row[t] < 0 ? 0 : col4row[t];
                u[t] = __fsub_rn(__fadd_rn(u[t], minval), spc[c]);
            }
        }
        for (int j = lane; j < Q; j += 32)
            if (SC[j]) v[j] = __fsub_rn(v[j], __fsub_rn(minval, spc[j]));
        __syncwarp();

        // augment along the alternating path, serially
        int ok = 0;
        if (lane == 0) {
            int j = sink;
            for (int s = 0; s < T; ++s) {
                const int r = path[j];
                row4col[j] = r;
                const int next = col4row[r];
                col4row[r] = j;
                if (r == cur) {
                    ok = 1;
                    break;
                }
                if (next < 0) break;
                j = next;
            }
        }
        ok = __shfl_sync(kFull, ok, 0);
        __syncwarp();
        if (!ok) break;        // non-finite costs: stop this problem
    }
    __syncwarp();
    long long* o = out + p * T;
    for (int t = lane; t < T; t += 32) o[t] = col4row[t] < 0 ? 0 : col4row[t];
}

}  // namespace

extern "C" int gw_lap_jv(const float* cost, const long long* n_valid,
                         long long* out, int n, int Q, int T,
                         cudaStream_t stream) {
    const size_t smem = sizeof(float) * (T + 2 * static_cast<size_t>(Q)) +
                        sizeof(int) * (2 * static_cast<size_t>(Q) + T) +
                        static_cast<size_t>(T) + Q;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            lap_jv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    lap_jv_kernel<<<n, 32, smem, stream>>>(cost, n_valid, out, Q, T);
    return static_cast<int>(cudaGetLastError());
}
