// An early-exit loop of CUDA graphs: K conditional IF nodes in a row,
// each running one captured iteration only while a device flag holds.
//
// Replaces no TPU kernel.  The reference's while megastep is one
// ``lax.while_loop`` (veles_tpu/serving/lm_engine.py, ``mega_while``):
// XLA stops the loop on the device as soon as its condition reads false.
// A CUDA graph has no loop of its own that PyTorch can capture into, so
// the port captures the loop's pieces with PyTorch (``keep_graph=True``:
// the set-up, ONE iteration, the packing of the output) and this file
// joins them into one executable graph:
//
//     pre -> [set_condition(h0) -> IF(h0) { iteration }]
//         -> [set_condition(h1) -> IF(h1) { iteration }] -> ...
//         -> post
//
// ``set_condition`` reads the one-byte flag that the set-up (for the
// first node) or the previous iteration wrote, and sets the node's
// handle from it.  A handle resets to 0 at every launch
// (cudaGraphCondAssignDefault), and once the flag reads false no later
// iteration runs to set it again, so the loop ends at the first false
// flag.  A skipped body writes nothing; the iteration therefore keeps its
// whole state in buffers allocated before the capture and updates them
// in place.
//
// Bound: one single-thread launch per iteration (about as long as an
// empty launch), against an iteration of several hundred microseconds.
//
// Plain C interface, loaded with ctypes; each function returns the
// cudaError_t of the first call that failed, or 0.

#include <cuda_runtime.h>

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const unsigned char* flag) {
    cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

#define CHECK(call)                                                       \
    do {                                                                  \
        cudaError_t err_ = (call);                                        \
        if (err_ != cudaSuccess) {                                        \
            cudaGraphDestroy(parent);                                     \
            return (int)err_;                                             \
        }                                                                 \
    } while (0)

// Build the loop from three captured graphs (``pre``, ``iteration``,
// ``post``; each is cloned, so the caller keeps and frees its own) and
// the device flag ``flag`` (one byte, nonzero = run the next
// iteration), ``iterations`` IF nodes at most.  Writes the instantiated
// graph to ``*exec_out``.
extern "C" int graph_while_build(void* pre, void* iteration, void* post,
                                 int iterations, const void* flag,
                                 void** exec_out) {
    cudaGraph_t parent = nullptr;
    cudaError_t err = cudaGraphCreate(&parent, 0);
    if (err != cudaSuccess) return (int)err;
    cudaGraphNode_t prev;
    CHECK(cudaGraphAddChildGraphNode(&prev, parent, nullptr, 0,
                                     (cudaGraph_t)pre));
    for (int i = 0; i < iterations; ++i) {
        cudaGraphConditionalHandle handle;
        CHECK(cudaGraphConditionalHandleCreate(&handle, parent, 0,
                                               cudaGraphCondAssignDefault));
        void* args[] = {&handle, (void*)&flag};
        cudaKernelNodeParams kp = {};
        kp.func = (void*)set_condition;
        kp.gridDim = dim3(1);
        kp.blockDim = dim3(1);
        kp.kernelParams = args;
        cudaGraphNode_t setter;
        CHECK(cudaGraphAddKernelNode(&setter, parent, &prev, 1, &kp));
        cudaGraphNodeParams cp = {};
        cp.type = cudaGraphNodeTypeConditional;
        cp.conditional.handle = handle;
        cp.conditional.type = cudaGraphCondTypeIf;
        cp.conditional.size = 1;
        cudaGraphNode_t node;
        CHECK(cudaGraphAddNode(&node, parent, &setter, 1, &cp));
        cudaGraphNode_t body;
        CHECK(cudaGraphAddChildGraphNode(&body, cp.conditional.phGraph_out[0],
                                         nullptr, 0,
                                         (cudaGraph_t)iteration));
        prev = node;
    }
    cudaGraphNode_t tail;
    CHECK(cudaGraphAddChildGraphNode(&tail, parent, &prev, 1,
                                     (cudaGraph_t)post));
    cudaGraphExec_t exec = nullptr;
    CHECK(cudaGraphInstantiate(&exec, parent, 0));
    cudaGraphDestroy(parent);
    *exec_out = (void*)exec;
    return 0;
}

// Launch the loop on ``stream`` (PyTorch's current stream).
extern "C" int graph_while_launch(void* exec, void* stream) {
    return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

extern "C" int graph_while_destroy(void* exec) {
    return (int)cudaGraphExecDestroy((cudaGraphExec_t)exec);
}
