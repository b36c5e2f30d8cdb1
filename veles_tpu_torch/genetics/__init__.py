"""Genetic hyperparameter optimization over ``Tune()`` config leaves.

Port of ``veles_tpu/genetics/__init__.py`` (ref: veles/genetics/ [H]):
config values wrapped in ``Tune(value, min, max)`` are genes; a GA
population evaluates full training runs and selects on the Decision's
best validation metric.  Driven by ``--optimize
GENERATIONS[:POPULATION[:WORKERS]]`` as in the reference.

``optimize_workflow(..., workers=N)`` screens each generation's
individuals across N worker subprocesses (genetics/eval_worker.py),
each on the device the parent resolved — the CUDA card unless the
caller passes ``device="cpu"`` — so parallel and sequential screening
agree bit for bit.  ``workers=0`` (default) runs individuals
sequentially in-process.
"""

from __future__ import annotations

import ast
import re

from veles_tpu_torch import prng
from veles_tpu_torch.config import Config, Tune, root
from veles_tpu_torch.logger import Logger


def _walk_container(value, path, out):
    """Recurse into list/dict leaves — layer configs keep their Tunes inside
    a list of dicts (``root.x.layers[0].learning_rate``).  Tuples are
    immutable (set_leaf could not write the gene back), so they are
    deliberately NOT descended."""
    if isinstance(value, Tune):
        out.append((path, value))
    elif isinstance(value, dict):
        for key, item in value.items():
            _walk_container(item, "%s[%r]" % (path, key), out)
    elif isinstance(value, list):
        for i, item in enumerate(value):
            _walk_container(item, "%s[%d]" % (path, i), out)


def find_tunes(node=None, prefix="root"):
    """[(path, Tune)] for every Tune leaf under ``node``, descending into
    Config children AND list/dict leaf values."""
    node = node if node is not None else root
    out = []
    for key, value in node.__dict__.items():
        if key == "_path_":
            continue
        path = "%s.%s" % (prefix, key)
        if isinstance(value, Config):
            out.extend(find_tunes(value, path))
        else:
            _walk_container(value, path, out)
    return sorted(out, key=lambda pair: pair[0])


_TOKEN = re.compile(r"\.?([A-Za-z_]\w*)|\[([^\]]+)\]")


def _tokenize(path):
    tokens = []
    for attr, index in _TOKEN.findall(path):
        if attr:
            tokens.append(("attr", attr))
        else:
            try:
                tokens.append(("item", ast.literal_eval(index)))
            except (ValueError, SyntaxError):
                tokens.append(("item", index))
    if tokens and tokens[0] == ("attr", "root"):
        tokens = tokens[1:]
    return tokens


def set_leaf(path, value, cfg=None):
    """Assign a (possibly container-indexed) config path, e.g.
    ``root.mnist.layers[0]['learning_rate']``."""
    node = cfg if cfg is not None else root
    tokens = _tokenize(path)
    for kind, token in tokens[:-1]:
        node = getattr(node, token) if kind == "attr" else node[token]
    kind, last = tokens[-1]
    if kind == "attr":
        setattr(node, last, value)
    else:
        node[last] = value


class Population(Logger):
    """Real-valued GA: tournament selection, blend crossover, gaussian
    mutation, elitism.  Fitness is MINIMIZED."""

    def __init__(self, genes, size=8, mutation_rate=0.3, mutation_scale=0.2,
                 elite=1, seed_stream="genetics"):
        #: genes: [(path, Tune)] — bounds come from the Tune markers
        self.genes = genes
        self.size = size
        self.mutation_rate = mutation_rate
        self.mutation_scale = mutation_scale
        self.elite = elite
        self.stream = prng.get(seed_stream)
        self.individuals = []      # list of [value per gene]
        self.fitnesses = []
        self.history = []          # per generation: (best_fitness, best_genes)
        self._spawn()

    def _spawn(self):
        self.individuals = []
        for i in range(self.size):
            if i == 0:     # seed individual = the configured values
                self.individuals.append(
                    [float(tune.value) for _, tune in self.genes])
            else:
                self.individuals.append([
                    float(self.stream.uniform(tune.minv, tune.maxv))
                    for _, tune in self.genes])

    def apply(self, individual, cfg=None):
        """Write an individual's gene values into the config tree."""
        for (path, _), value in zip(self.genes, individual):
            set_leaf(path, value, cfg)

    def evolve(self):
        """One generation step from self.fitnesses → new individuals."""
        order = sorted(range(len(self.individuals)),
                       key=lambda i: self.fitnesses[i])
        best = self.individuals[order[0]]
        self.history.append((self.fitnesses[order[0]], list(best)))
        next_gen = [list(self.individuals[i]) for i in order[:self.elite]]

        def tournament():
            a, b = (int(self.stream.uniform(0, len(order))) for _ in "ab")
            return self.individuals[min(a, b, key=lambda i:
                                        self.fitnesses[i])]

        while len(next_gen) < self.size:
            pa, pb = tournament(), tournament()
            child = []
            for (_, tune), va, vb in zip(self.genes, pa, pb):
                mix = self.stream.uniform(0.0, 1.0)
                value = mix * va + (1.0 - mix) * vb
                if self.stream.uniform(0.0, 1.0) < self.mutation_rate:
                    span = tune.maxv - tune.minv
                    value += self.stream.normal(
                        0.0, self.mutation_scale * span)
                child.append(float(min(max(value, tune.minv), tune.maxv)))
            next_gen.append(child)
        self.individuals = next_gen
        self.fitnesses = []
        return best


def optimize(evaluate, generations=5, population=8, genes=None,
             log=None, batch_evaluate=None):
    """Run the GA: ``evaluate(individual_as_config_applied) -> fitness``.

    ``genes`` defaults to every Tune leaf under root.  When
    ``batch_evaluate`` is given it receives the generation's UNCACHED
    individuals as one list (population-parallel screening); ``evaluate``
    is then unused.  Returns (best_fitness, best_gene_dict, population).
    """
    genes = genes if genes is not None else find_tunes()
    if not genes:
        raise ValueError("no Tune(...) leaves found in the config tree — "
                         "wrap values to optimize in Tune(value, min, max)")
    pop = Population(genes, size=population)
    # evaluations are deterministic (fixed seed per run), so carried-over
    # elites reuse their cached fitness instead of re-training
    fitness_cache = {}
    for gen in range(generations):
        fresh, seen = [], set()
        for ind in pop.individuals:       # dedupe: identical individuals
            key = tuple(ind)              # (converged populations, twin
            if key not in fitness_cache and key not in seen:
                fresh.append(ind)         # crossover children) train once
                seen.add(key)
        if batch_evaluate is not None:
            for ind, fit in zip(fresh, batch_evaluate(fresh) if fresh
                                else []):
                fitness_cache[tuple(ind)] = fit
        else:
            for individual in fresh:
                pop.apply(individual)
                fitness_cache[tuple(individual)] = evaluate(individual)
        pop.fitnesses = [fitness_cache[tuple(ind)]
                         for ind in pop.individuals]
        best = pop.evolve()
        if log:
            log("generation %d: best fitness %.6g (%s)" %
                (gen, pop.history[-1][0],
                 {p: round(v, 6) for (p, _), v in zip(genes, best)}))
    best_fit, best_genes = min(pop.history)
    # leave the config tree holding the WINNER, not the last-evaluated
    # individual — "optimize, then train" must train the reported best
    pop.apply(best_genes)
    return best_fit, {path: value for (path, _), value in
                      zip(genes, best_genes)}, pop


def _fitness(metric):
    return float("inf") if metric is None else float(metric)


def evaluate_population(module_name, genes, individuals, seed,
                        workers, build_kwargs=None, device=None):
    """Fitnesses of ``individuals``, evaluated across ``workers``
    subprocesses on ``device`` (None: the CUDA card, raising without
    one).

    Each worker receives the FULL current config tree, its gene values
    and this process's :func:`subproc.process_state`, so it reproduces
    exactly what the in-process evaluation would have trained.  Results
    arrive in individual order.
    """
    from veles_tpu_torch.device import resolve_device
    from veles_tpu_torch.subproc import (plain_config, process_state,
                                         run_workers)

    device = str(resolve_device(device))
    config_snapshot = plain_config(root.as_dict())
    state = process_state()
    specs = [{
        "config": config_snapshot,
        "genes": {path: value for (path, _), value in
                  zip(genes, individual)},
        "module": module_name, "seed": seed,
        "build_kwargs": build_kwargs, "device": device, "process": state,
    } for individual in individuals]
    results = run_workers("veles_tpu_torch.genetics.eval_worker", specs,
                          workers)
    return [_fitness(r["fitness"]) for r in results]


def optimize_workflow(module, generations=5, population=8, seed=1,
                      build_kwargs=None, workers=0, device=None):
    """GA over a sample module exposing ``run(load, main)``.

    Fitness = the Decision's best validation metric of a full (short)
    run on ``device`` (None: the CUDA card, raising without one).  Each
    evaluation reseeds every PRNG stream so individuals differ only by
    their genes.  ``workers > 0`` screens each generation's individuals
    across that many subprocesses on the same device (``module`` must be
    importable by name); runs are deterministic in (config, genes, seed,
    device), so parallel and sequential screening agree exactly.  The
    winner is left in the config tree.
    """
    from veles_tpu_torch.device import resolve_device
    device = str(resolve_device(device))
    logger = Logger()
    genes = find_tunes()

    batch_evaluate = None
    if workers > 0:
        def batch_evaluate(fresh):
            return evaluate_population(module.__name__, genes, fresh,
                                       seed, workers, build_kwargs,
                                       device=device)

    def evaluate(individual):
        from veles_tpu_torch.samples import run_sample
        wf = run_sample(module, seed=seed, build_kwargs=build_kwargs,
                        device=device)
        return _fitness(wf.decision.best_metric)

    return optimize(evaluate, generations=generations, population=population,
                    genes=genes, log=logger.info,
                    batch_evaluate=batch_evaluate)


def optimize_cli(module, args):
    """--optimize entry point (ref: Main --optimize [H]).

    Spec: ``<generations>[:<population>[:<workers>]]`` — workers > 0
    screens individuals across that many subprocesses on the CLI's
    device (``-d``; the CUDA card by default).
    """
    parts = [int(x) for x in str(args.optimize).split(":")]
    generations = parts[0]
    population = parts[1] if len(parts) > 1 else 8
    workers = parts[2] if len(parts) > 2 else 0
    best_fit, best_genes, _ = optimize_workflow(
        module, generations=generations, population=population,
        seed=args.random_seed or 1, workers=workers,
        device=None if args.device == "cuda" else args.device)
    print("best fitness: %s" % best_fit)
    for path, value in best_genes.items():
        print("  %s = %s" % (path, value))
    return 0
