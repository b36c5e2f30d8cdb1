"""One gloo rank of the port's expert-parallel MoE checks
(``tests/test_torch_moe.py``).

    python tests/torch_moe_worker.py PORT WORLD RANK INPUTS.npz OUTDIR

``INPUTS.npz`` holds the MoE params (``router``, ``w1``, ``b1``, ``w2``,
``b2``) and the input ``x``.  Every rank joins a run of WORLD ranks on
the CPU, then for each expert-axis size n in (2, 4) lays the ranks out
as a ``("data", "expert")`` mesh with n ranks a row and takes the value
and the gradients of ``(moe_ffn_ep(params, x, mesh) ** 2).sum()``, once
with the whole tree and once with the rank's own (``expert_slice``,
copied: the rank holds E/n experts).  It writes ``OUTDIR/rank<R>.npz``:
per n the output, the loss, the router and input gradients, this rank's
expert slice of each expert gradient (``ep<n>:grad/<key>``), the slice's
first expert (``ep<n>:lo``) and the collective counts of the call, and
the sliced call's output, loss and gradients (``ep<n>:sliced/...``) and
the bytes of expert weights each call's tree held
(``ep<n>:expert_bytes``, ``ep<n>:sliced/expert_bytes``).
"""

import sys

import numpy
import torch

KEYS = ("router", "w1", "b1", "w2", "b2")


def main(port, world, rank, inputs_path, outdir):
    torch.set_num_threads(1)
    from veles_tpu_torch import parallel
    from veles_tpu_torch.ops.moe import EXPERT_KEYS, expert_slice, moe_ffn_ep
    inputs = numpy.load(inputs_path)
    parallel.initialize_multihost("127.0.0.1:%d" % port, world, rank,
                                  device="cpu")
    out = {}
    try:
        for n in (2, 4):
            mesh = parallel.make_mesh(model_parallel=n,
                                      axis_names=("data", "expert"))
            params = {k: torch.tensor(inputs[k], requires_grad=True)
                      for k in KEYS}
            x = torch.tensor(inputs["x"], requires_grad=True)
            parallel.reset_collective_counts()
            y = moe_ffn_ep(params, x, mesh)
            loss = (y ** 2).sum()
            grads = torch.autograd.grad(loss, [params[k] for k in KEYS]
                                        + [x])
            counts = parallel.collective_counts()
            k = inputs["w1"].shape[0] // n
            lo = mesh.index("expert") * k
            tag = "ep%d:" % n
            out[tag + "out"] = y.detach().numpy()
            out[tag + "loss"] = loss.detach().numpy()
            out[tag + "lo"] = numpy.asarray(lo)
            out[tag + "x_grad"] = grads[-1].numpy()
            for key, g in zip(KEYS, grads):
                g = g.numpy()
                out[tag + "grad/" + key] = g if key == "router" else \
                    g[lo:lo + k]
            for name, v in counts.items():
                out[tag + "count/" + name] = numpy.asarray(v)
            # the rank's own tree: E/n experts, copied out of the whole
            own = {key: v.detach().clone().requires_grad_()
                   for key, v in expert_slice(params, mesh).items()}
            xs = x.detach().clone().requires_grad_()
            ys = moe_ffn_ep(own, xs, mesh)
            loss = (ys ** 2).sum()
            grads = torch.autograd.grad(loss, [own[key] for key in KEYS]
                                        + [xs])
            sub = tag + "sliced/"
            out[sub + "out"] = ys.detach().numpy()
            out[sub + "loss"] = loss.detach().numpy()
            out[sub + "x_grad"] = grads[-1].numpy()
            for key, g in zip(KEYS, grads):
                out[sub + "grad/" + key] = g.numpy()
            for name, tree in (("", params), ("sliced/", own)):
                out[tag + name + "expert_bytes"] = numpy.asarray(sum(
                    tree[key].numel() * tree[key].element_size()
                    for key in EXPERT_KEYS))
    finally:
        parallel.shutdown()
    numpy.savez("%s/rank%d.npz" % (outdir, rank), **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                  sys.argv[4], sys.argv[5]))
