"""One gloo rank of the port's ring-attention checks
(``tests/test_torch_ring.py``).

    python tests/torch_ring_worker.py PORT WORLD RANK INPUTS.npz OUTDIR

``INPUTS.npz`` holds q, k, v (batch, heads, seq, head_dim), the LM's
params for the injected forward (``lm/<path>``) and its tokens.  Every
rank joins a run of WORLD ranks on the CPU and runs each case of
``CASES`` on its ``(data, seq)`` grid: the global output of
``ring_attention``, the gradients of sum(out²) for q, k and v, this
rank's ``ring_attention_local`` block of the same case and the skip
counts; then ``transformer_forward`` with the ring injected as
``attn_fn`` on the (1, WORLD) grid.  It writes ``OUTDIR/rank<R>.npz``.
"""

import sys

import numpy
import torch

#: name -> (data_parallel, causal, window, sinks)
CASES = {
    "dp2_causal": (2, True, None, 0),
    "dp2_full": (2, False, None, 0),
    "dp1_causal": (1, True, None, 0),
    "dp1_full": (1, False, None, 0),
    "window1": (1, True, 1, 0),
    "window5": (1, True, 5, 0),
    "window12": (1, True, 12, 0),
    "window999": (1, True, 999, 0),
    "window5_sinks3": (1, True, 5, 3),
    "window2_sinks1": (1, True, 2, 1),
}


def unflatten(flat, prefix):
    """{"a/b/0/c": array} (keys under ``prefix``) -> nested dicts/lists
    of tensors."""
    tree = {}
    for key in sorted(k for k in flat if k.startswith(prefix)):
        parts = key[len(prefix):].split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.tensor(flat[key])

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[k]) for k in sorted(node, key=int)]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


def ring_attn_fn(mesh, n_heads):
    """``attn_fn`` for ``block_forward``: the block's projections, the
    ring, the output projection (``tests/test_transformer.py``'s)."""
    from veles_tpu_torch.ops.functional import matmul
    from veles_tpu_torch.parallel.ring import ring_attention

    def attn(p, x):
        b, s, d = x.shape
        dh = d // n_heads

        def split(w):
            return matmul(x, w).reshape(b, s, n_heads, dh).transpose(1, 2)

        q, k, v = (split(p[key]) for key in ("wq", "wk", "wv"))
        o = ring_attention(q, k, v, mesh, causal=True)
        return matmul(o.transpose(1, 2).reshape(b, s, d), p["wo"])

    return attn


def main(port, world, rank, inputs_path, outdir):
    torch.set_num_threads(1)
    from veles_tpu_torch import parallel
    from veles_tpu_torch.ops import transformer as TT
    from veles_tpu_torch.parallel import ring
    inputs = dict(numpy.load(inputs_path))
    parallel.initialize_multihost("127.0.0.1:%d" % port, world, rank,
                                  device="cpu")
    out = {}
    try:
        meshes = {dp: ring.make_seq_mesh(world, data_parallel=dp)
                  for dp in (1, 2)}
        for name, (dp, causal, window, sinks) in CASES.items():
            mesh = meshes[dp]
            q, k, v = (torch.tensor(inputs[n], requires_grad=True)
                       for n in "qkv")
            y = ring.ring_attention(q, k, v, mesh, causal=causal,
                                    window=window, sinks=sinks)
            grads = torch.autograd.grad((y ** 2).sum(), [q, k, v])
            out[name + ":out"] = y.detach().numpy()
            for n, g in zip("qkv", grads):
                out["%s:d%s" % (name, n)] = g.numpy()
            blocks = [ring._block(torch.tensor(inputs[n]), mesh,
                                  ("data", "seq")) for n in "qkv"]
            local = ring.ring_attention_local(
                *[b.contiguous() for b in blocks], mesh, causal=causal,
                window=window, sinks=sinks)
            out[name + ":local"] = local.numpy()
            counts = ring.ring_attention_local.counts
            out[name + ":attends"] = numpy.asarray(counts["attends"])
            out[name + ":skipped"] = numpy.asarray(counts["skipped"])
        params = unflatten(inputs, "lm/")
        with torch.no_grad():
            logits = TT.transformer_forward(
                params, torch.tensor(inputs["tokens"]), 2,
                attn_fn=ring_attn_fn(meshes[1], 2))
        out["lm:logits"] = logits.numpy()
        out["counts"] = numpy.asarray(
            [parallel.collective_counts()[k] for k in (
                "p2p_exchange", "ring_all_gather",
                "ring_input_grad_all_reduce")])
    finally:
        parallel.shutdown()
    numpy.savez("%s/rank%d.npz" % (outdir, rank), **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                  sys.argv[4], sys.argv[5]))
