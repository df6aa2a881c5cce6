"""The dry run on H100s (port of ``repro.launch.dryrun``): every
(architecture x input shape) cell traced on ``repro``'s production layouts,
16x16 or 2x16x16 H100s, with its memory, FLOPs, HBM bytes and collectives a
device and an H100 roofline.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --include-ngram

``repro`` lowers and compiles each cell for 512 forced XLA host devices.
The port runs each cell's step once, as rank 0 of a ``fake`` process group
of 256 or 512 ranks (``launch.mesh.make_production_mesh``), on DTensors of
fake tensors placed by the cell's specs: DTensor's sharding propagation
stands in for GSPMD.  Where GSPMD's layout needs code of its own, and
where ``repro`` writes a ``shard_map`` (the sharded MoE, GIN's message
passing, the n-gram job), a region runs on rank 0's shards: the n-gram
job's own, and those of ``launch.regions``, installed for every trace.  Nothing is allocated and no kernel launches.  Fake tensors lie on
the card unless ``--device cpu``; without a card and without
``--device cpu`` the dry run fails.

What a device runs is counted under :class:`Trace`, a fake-tensor mode that
sees every op run on local shards: FLOPs (``torch.utils.flop_counter``'s
registry on the local shapes), HBM bytes (inputs read and outputs written
once; views and allocations move none) and the result bytes of each
collective by kind, and the peak of the local storages alive.
``memory.argument_bytes`` is exact from the shard shapes; ``temp_bytes`` is
the peak less the arguments.

An LM cell is traced at one and two layers and one and two microbatches
(of its own microbatch size) and extrapolated to its depth (``repro``'s
scan correction): every count is linear in the layers for a given number
of microbatches, and in the microbatches for a given number of layers, so
four traces of at most two layers give the whole step's counts exactly.
"""
from __future__ import annotations

import argparse
import collections
import json
import math
import time
import traceback
import weakref
from pathlib import Path

import torch

from repro_torch import configs
from repro_torch.launch import regions, roofline
from repro_torch.launch.mesh import contiguous_stride, make_production_mesh, placements

COLLECTIVE_KINDS = {"all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
                    "all_reduce": "all-reduce", "all_to_all": "all-to-all",
                    "alltoall": "all-to-all", "permute": "collective-permute"}


def _tensors(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples (a layer leaf's
    ``Stacked`` included)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return []
    return [t for sub in tree for t in _tensors(sub)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


# ops that allocate, alias or read metadata: no bytes move
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
             "device", "detach", "alias", "lift_fresh", "_local_scalar_dense", "sym_size",
             "sym_stride", "sym_numel", "sym_storage_offset", "dim", "is_same_size", "set_"}


_SCANS = {torch.ops.aten.cumsum.default, torch.ops.aten.cumprod.default}


def _scan_shape(x, dim, dtype=None):
    """A scan's fake result, made directly: the fake mode's own runs the
    reference decomposition, whose [n, n] mask overflows at the n-gram
    job's 10^9-row scans."""
    if dtype is None:
        dtype = torch.int64 if not (x.is_floating_point() or x.is_complex()) else x.dtype
    return torch.empty_like(x, dtype=dtype, memory_format=torch.contiguous_format)


class Trace:
    """A fake-tensor mode that counts what one device runs.

    Every op on local tensors (a DTensor's ops run on its local shards
    below it) is counted once, at the outermost level: an op that the fake
    mode decomposes counts as itself.  The global-shape fake ops that
    DTensor's sharding propagation runs to infer shapes are not counted."""

    def __init__(self):
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        from torch.utils.flop_counter import flop_registry

        trace = self
        self.flops = 0
        self.bytes = 0
        self.collectives = collections.Counter()
        self.live = 0                   # bytes of the local storages alive
        self.peak = 0
        self._storages: set = set()
        self._depth = 0
        self._paused = 0
        self._registry = flop_registry

        class Mode(FakeTensorMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                trace._depth += 1
                try:
                    if func in _SCANS and not trace._paused and not any(
                            isinstance(t, DTensor) for t in _tensors(args)):
                        out = _scan_shape(*args, **(kwargs or {}))
                    else:
                        out = super().__torch_dispatch__(func, types, args, kwargs)
                finally:
                    trace._depth -= 1
                if out is NotImplemented or trace._depth or trace._paused:
                    return out
                ins = _tensors((args, kwargs or {}))
                if not any(isinstance(t, DTensor) for t in ins):
                    trace._count(func, args, kwargs or {}, ins, out)
                return out

        self.mode = Mode()
        self._prop = ShardingPropagator
        self._orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def _free(self, key, n: int) -> None:
        self._storages.discard(key)
        self.live -= n

    def _track(self, out) -> None:
        """Add each new storage among ``out``'s tensors to the live bytes,
        until it is freed."""
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages:
                continue
            n = st.nbytes()
            self._storages.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)

    def _count(self, func, args, kwargs, ins, out) -> None:
        name = func._schema.name.split("::")[-1]
        self._track(out)
        if func.namespace == "_c10d_functional" or func.namespace == "_dtensor":
            for key, kind in COLLECTIVE_KINDS.items():
                if key in name:
                    self.collectives[kind] += sum(_nbytes(t) for t in _tensors(out))
                    self.collectives["count"] += 1
                    return
            return
        fn = self._registry.get(func._overloadpacket)
        if fn is not None:
            self.flops += int(fn(*args, **kwargs, out_val=out))
        if name in _NO_BYTES or _is_view(func):
            return
        seen = {id(t) for t in ins}
        outs = [t for t in _tensors(out) if id(t) not in seen]
        self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)

    def counts(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": dict(self.collectives)}

    def __enter__(self):
        trace, orig = self, self._orig

        def propagate(prop, schema):     # global shapes only: not a device's work
            trace._paused += 1
            try:
                return orig(prop, schema)
            finally:
                trace._paused -= 1
        self._prop._propagate_tensor_meta_non_cached = propagate
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)
        self._prop._propagate_tensor_meta_non_cached = self._orig
        return False


# --------------------------------------------------------------- arguments
def _empty(shape, dtype, device):
    return torch.empty(shape, dtype=dtype, device=device)


def _materialize(spec_leaf, p_spec, mesh, device, make=_empty):
    """A DTensor (or, for a layer leaf, one a layer) of ``spec_leaf``
    placed by ``p_spec``, its local shard ``make(shape, dtype, device)``."""
    from torch.distributed.tensor import DTensor
    from repro_torch.training.tree import Stacked

    def one(shape, spec):
        t = make(configs.base.shard_shape(mesh, spec, shape), spec_leaf.dtype, device)
        return DTensor.from_local(t, mesh, placements(mesh, spec), run_check=False,
                                  shape=torch.Size(shape), stride=contiguous_stride(shape))

    if spec_leaf.layers:
        if p_spec[0] is not None:
            raise ValueError(f"a layer leaf split over its layers: {p_spec}")
        inner = configs.base.P(*p_spec[1:])
        return Stacked(one(spec_leaf.shape[1:], inner) for _ in range(spec_leaf.shape[0]))
    return one(spec_leaf.shape, p_spec)


def arguments(cell, mesh, device, make=_empty) -> tuple:
    """The cell's arguments as DTensors on ``mesh`` (the cell's own mesh if
    it has one), each local shard ``make(shape, dtype, device)``: under a
    :class:`Trace`, ``torch.empty`` makes fake tensors."""
    mesh = mesh if cell.mesh is None else cell.mesh
    return tuple(_zip_map(lambda leaf, spec: _materialize(leaf, spec, mesh, device, make),
                          a, s) for a, s in zip(cell.args, cell.in_specs))


def _zip_map(fn, tree, specs):
    if isinstance(tree, configs.base.TensorSpec):
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, s) for v, s in zip(tree, specs))
    return tree


def argument_bytes(cell, mesh) -> int:
    """Bytes a device holds of the cell's arguments: exact from the shard
    shapes."""
    mesh = mesh if cell.mesh is None else cell.mesh
    return sum(math.prod(configs.base.shard_shape(mesh, spec, leaf.shape)) * leaf.dtype.itemsize
               for _, leaf, spec in configs.base.cell_leaves(cell))


def _local(t):
    from repro_torch.launch.mesh import is_dtensor
    return t.to_local() if is_dtensor(t) else t


def trace(cell, mesh, device) -> dict:
    """Run ``cell``'s step once on fake DTensors; the counts a device runs,
    its peak of live bytes and its output and aliased bytes."""
    from torch.distributed.tensor.experimental import implicit_replication

    tr = Trace()
    with tr, implicit_replication(), regions.installed():
        args = arguments(cell, mesh, device)
        ins = {_local(t).untyped_storage()._cdata for t in _tensors(args)}
        out = cell.step_fn(*args)
        outs = [_local(t) for t in _tensors(out)]
    counts = tr.counts()
    counts["peak_bytes"] = tr.peak
    counts["output_bytes"] = sum(_nbytes(t) for t in outs)
    counts["alias_bytes"] = sum(_nbytes(t) for t in outs
                                if t.untyped_storage()._cdata in ins)
    return counts


def _combine(terms: list[tuple[float, dict]]) -> dict:
    """sum of weight * counts over ``terms`` (every number, and each
    collective kind)."""
    out = {"flops": 0, "bytes": 0, "collectives": collections.Counter(),
           "peak_bytes": 0, "output_bytes": 0, "alias_bytes": 0}
    for w, c in terms:
        for k in ("flops", "bytes", "peak_bytes", "output_bytes", "alias_bytes"):
            out[k] += w * c[k]
        for k, v in c["collectives"].items():
            out["collectives"][k] += w * v
    out = {k: (int(round(v)) if isinstance(v, (int, float)) else v) for k, v in out.items()}
    out["collectives"] = {k: int(round(v)) for k, v in out["collectives"].items()}
    return out


def probe(at_depth, layers: int, micro: int, mesh, device) -> dict:
    """The counts of a cell at ``layers`` layers and ``micro`` microbatches
    from traces of ``at_depth(l, m)`` at no more than two of each: with
    T(l, m) the trace at l layers and m microbatches,

        T(L, n) = T11 + (L - 1) dL + (n - 1) dM + (L - 1)(n - 1) dLM,

    dL = T21 - T11, dM = T12 - T11, dLM = T22 - T21 - T12 + T11.  The peak
    is extrapolated over the layers alone (a microbatch frees what it
    holds before the next)."""
    t11 = trace(at_depth(1, 1), mesh, device)
    t21 = trace(at_depth(2, 1), mesh, device) if layers > 1 else t11
    terms = [(1, t11), (layers - 1, t21), (-(layers - 1), t11)]
    if micro > 1:
        t12 = trace(at_depth(1, 2), mesh, device)
        t22 = trace(at_depth(2, 2), mesh, device) if layers > 1 else t12
        terms += [(micro - 1, t12), (-(micro - 1), t11),
                  ((layers - 1) * (micro - 1), t22), (-(layers - 1) * (micro - 1), t21),
                  (-(layers - 1) * (micro - 1), t12), ((layers - 1) * (micro - 1), t11)]
    out = _combine(terms)
    peak = t11["peak_bytes"] + (layers - 1) * (t21["peak_bytes"] - t11["peak_bytes"])
    out["peak_bytes"] = int(peak)
    return out


def measure(cell, mesh, device) -> dict:
    """The cell's counts: traced once, or by :func:`probe` at its depth."""
    if cell.at_depth is not None:
        return probe(cell.at_depth, *cell.depth, mesh, device)
    return trace(cell, mesh, device)


# ---------------------------------------------------------------------- cells
def compute_dtype(cell) -> torch.dtype:
    """The dtype a cell's matmuls run in: the floating dtype that holds most
    of its first argument's bytes (its parameters; bf16 for the LMs, float32
    for the recsys archs and GIN), bf16 where it has none (the n-gram job,
    which multiplies no matrices)."""
    by: collections.Counter = collections.Counter()
    for name, leaf, _ in configs.base.cell_leaves(cell):
        if name.split("/")[0] == "0" and leaf.dtype.is_floating_point:
            by[leaf.dtype] += math.prod(leaf.shape) * leaf.dtype.itemsize
    return by.most_common(1)[0][0] if by else torch.bfloat16


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape: str, multi_pod: bool, mesh, device: str = "cuda",
             verbose: bool = True) -> dict:
    """One cell's record, ``repro``'s keys (``trace_s`` for ``lower_s`` and
    ``compile_s``), on the production mesh ``mesh``."""
    ad = configs.get(arch)
    sd = ad.shapes[shape]
    rec: dict = {"arch": arch, "shape": shape, "mesh": _mesh_name(multi_pod)}
    if sd.skip_reason:
        rec["status"] = "skipped"
        rec["reason"] = sd.skip_reason
        return rec
    t0 = time.time()
    cell = ad.build_cell(ad.make(), sd, mesh)
    counts = measure(cell, mesh, device)
    rec["trace_s"] = round(time.time() - t0, 2)
    args = argument_bytes(cell, mesh)
    rec["memory"] = {
        "argument_bytes": args,
        "output_bytes": counts["output_bytes"],
        "temp_bytes": max(counts["peak_bytes"] - args, 0),
        "alias_bytes": counts["alias_bytes"],
        "code_bytes": 0,
    }
    rl = roofline.analyze(counts, chips=mesh.size(), model_flops=cell.model_flops,
                          dtype=compute_dtype(cell))
    rec["roofline"] = rl.to_dict()
    rec["status"] = "ok"
    rec["kind"] = cell.kind
    rec["notes"] = cell.notes
    if verbose:
        r = rec["roofline"]
        print(f"  [{rec['mesh']}] {arch}/{shape}: trace {rec['trace_s']}s  "
              f"bottleneck={r['bottleneck']}  t={r['step_time_s'] * 1e3:.2f}ms  "
              f"roofline_frac={r['roofline_fraction']:.3f}", flush=True)
    return rec


def all_cells(include_ngram: bool) -> list[tuple[str, str]]:
    cells = [(a, s) for a in configs.ASSIGNED for s in configs.get(a).shapes]
    if include_ngram:
        cells += [("ngram-suffix-sigma", s)
                  for s in configs.get("ngram-suffix-sigma").shapes]
    return cells


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--out", default="dryrun_results")
    ap.add_argument("--include-ngram", action="store_true",
                    help="also dry-run the paper's own n-gram pipeline cells")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the fake tensors lie (the card by default)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the dry run traces on the card "
                           "unless --device cpu is given")

    outdir = Path(args.out)
    outdir.mkdir(exist_ok=True)
    if args.all:
        cells = all_cells(args.include_ngram)
    else:
        assert args.arch and args.shape, "--arch and --shape (or --all)"
        cells = [(args.arch, args.shape)]

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    n_ok = n_skip = n_fail = 0
    for multi in meshes:
        with make_production_mesh(multi_pod=multi, device_type=args.device) as mesh:
            for arch, shape in cells:
                tag = f"{arch}__{shape}__{'multi' if multi else 'single'}".replace(
                    "/", "_").replace(".", "_")
                fpath = outdir / f"{tag}.json"
                if fpath.exists():
                    rec = json.loads(fpath.read_text())
                    print(f"  [cached] {arch}/{shape} {_mesh_name(multi)}: {rec['status']}")
                else:
                    try:
                        rec = run_cell(arch, shape, multi, mesh, args.device)
                    except Exception as e:  # noqa: BLE001
                        rec = {"arch": arch, "shape": shape, "mesh": _mesh_name(multi),
                               "status": "failed", "error": f"{type(e).__name__}: {e}",
                               "traceback": traceback.format_exc()[-2000:]}
                        print(f"  FAILED {arch}/{shape}: {e}", flush=True)
                    fpath.write_text(json.dumps(rec, indent=1))
                n_ok += rec["status"] == "ok"
                n_skip += rec["status"] == "skipped"
                n_fail += rec["status"] == "failed"
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped (documented), {n_fail} failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
