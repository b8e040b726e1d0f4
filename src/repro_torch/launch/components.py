"""Per-device costs of a traced step, and the LM's component costs.

The reference compiles each (arch, shape) step for 512 forced host devices
and reads XLA's per-device ``cost_analysis``, its memory analysis and the
collectives of the partitioned HLO. torch has no compiled artifact, so the
port runs the step itself on ``meta`` tensors (no data, no arithmetic) as
DTensors on a fake world of 256 or 512 ranks, and :class:`LocalCosts`, a
dispatch mode, reads every aten op that one rank would run:

* ``flops``: the matmul-class FLOPs of each *local* op (torch's
  ``flop_registry``: mm, bmm, addmm, baddbmm, convolution, attention), so a
  product split 16 ways counts a sixteenth; the mode lets a DTensor op
  through to DTensor (which turns it into local ops on each rank's shard,
  then the mode sees those) and skips the whole-tensor shape inference that
  DTensor runs under its own fake mode;
* ``bytes``: the bytes each local op reads and writes (its tensor inputs
  and outputs), views and identity ops excluded, with **no fusion**: an
  upper bound on what a fused program would move;
* ``collectives``: each functional collective DTensor issues (its kind, the
  bytes of its result and its group's size), priced by the reference's
  ring formulas (:func:`repro_torch.launch.roofline.collective_totals`);
* ``peak_bytes``: the most bytes of local storage alive at once, counting
  the tensors registered with :meth:`LocalCosts.track` (parameters,
  optimizer state, the batch) and every storage an op makes until it is
  freed; ``peaks`` splits it by the ``phase`` the caller names (a train
  step's ``step`` and ``optimizer``).

:func:`lm_component_costs` splits an LM cell as the reference's
``components.py`` does, into the model's own functions, each traced once
(the cell's totals come from whole steps, ``dryrun.lm_costs``, which adds
what only the whole step does):

    train   = L x (layer forward + backward under checkpoint) + head and
              loss + embedding + optimizer
    prefill = L x layer + head
    decode  = L x decode layer (with the new token's own slot) + head
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs.registry import ArchSpec, ShapeSpec
from repro_torch.distributed.sharding import placements, resolve, sharding_rules, use_mesh
from repro_torch.launch.roofline import collective_totals
from repro_torch.models import transformer as tfm
from repro_torch.models.param import ArraySpec, distribute_params
from repro_torch.optim import AdamW, AdamWConfig

#: the functional collectives DTensor issues, by the reference's names
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",  # DTensor's own (namespace _dtensor)
}
#: functional-collective ops that move nothing (a wait, an autograd wrapper):
#: their result is their input's buffer (on ``meta`` a new storage, counted
#: as the input's)
_IDENTITY = {"wait_tensor", "_wrap_tensor_autograd"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _group_size(group_name) -> int:
    return dist.distributed_c10d._resolve_process_group(group_name).size()


class LocalCosts(TorchDispatchMode):
    """Counts one rank's work while active (see the module docstring):
    ``flops``, ``bytes``, ``collectives`` (records of ``(kind, result
    bytes, group size)``), ``peak_bytes`` and ``live_bytes``. Use a fresh
    instance per measurement."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: list[tuple[str, int, int]] = []
        self.live_bytes = 0
        self.phase = "step"
        self.peaks: dict[str, int] = {}
        self._storages = WeakIdKeyDictionary()
        self._aliases = WeakIdKeyDictionary()  # a result's storage -> its input

    @property
    def peak_bytes(self) -> int:
        return max(self.peaks.values(), default=0)

    def track(self, *trees) -> "LocalCosts":
        """Count the storages of the tensors in ``trees`` (a DTensor: its
        local shard) as alive from now until they are freed."""
        for t in _tensors(trees):
            self._add(t.to_local() if isinstance(t, DTensor) else t)
        return self

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._storages or st in self._aliases:
            return
        n = st.nbytes()
        self._storages[st] = n
        self.live_bytes += n
        self.peaks[self.phase] = max(self.peaks.get(self.phase, 0), self.live_bytes)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def collective_totals(self) -> dict:
        return collective_totals(self.collectives)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor turns it into local ops, seen next
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out  # DTensor's shape inference on whole tensors, not a rank's work
        outs = list(_tensors(out))
        name = func._schema.name
        ns, _, op = name.partition("::")
        collective = ns in ("_c10d_functional", "c10d_functional")
        if collective and op in _IDENTITY:
            src = next(_tensors(args))
            for t in outs:  # the input's buffer lives while the result does
                if t.untyped_storage() is not src.untyped_storage():
                    self._aliases[t.untyped_storage()] = src
            return out
        for t in outs:
            self._add(t)
        if collective or name == "_dtensor::shard_dim_alltoall":
            kind = _COLLECTIVES.get(op)
            if kind is None:
                raise ValueError(f"LocalCosts: no ring formula for {name}")
            group = args[3] if kind == "all-to-all" else args[-1]
            for t in outs:
                self.collectives.append((kind, _nbytes(t), _group_size(group)))
        if func.overloadpacket in flop_registry:
            self.flops += flop_registry[func.overloadpacket](*args, **kwargs, out_val=out)
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs))) + sum(
                _nbytes(t) for t in outs)
        return out

    def record(self) -> dict:
        """``{flops, bytes, collective_bytes}`` per device."""
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "collective_bytes": self.collective_totals()["total_bytes_per_device"]}


# ------------------------------------------------------------- placement


def place(t: torch.Tensor, logical, rules: dict, mesh) -> DTensor:
    """``t`` (every rank's same tensor) as a DTensor on ``mesh``, split as
    the logical names resolve under ``rules``; no data moves."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, placements(mesh, resolve(logical, rules)),
                             src_data_rank=None)


def place_tree(spec_tree, rules: dict, mesh, requires_grad: bool = False):
    """A tree of :class:`ArraySpec` as ``meta`` DTensors placed by ``rules``."""
    if isinstance(spec_tree, ArraySpec):
        t = place(torch.empty(spec_tree.shape, dtype=spec_tree.dtype, device="meta"),
                  spec_tree.logical, rules, mesh)
        return t.requires_grad_(requires_grad) if requires_grad else t
    if isinstance(spec_tree, dict):
        return {k: place_tree(v, rules, mesh, requires_grad) for k, v in spec_tree.items()}
    return type(spec_tree)(place_tree(v, rules, mesh, requires_grad) for v in spec_tree)


def _layer_slice_specs(cfg: tfm.TransformerConfig) -> dict:
    """One layer's slice of the stacked layer leaves."""
    return {k: ArraySpec(s.shape[1:], s.logical[1:], s.dtype, s.init)
            for k, s in tfm.param_specs(cfg)["layers"].items()}


def _measure(fn, *tracked) -> dict:
    costs = LocalCosts().track(*tracked)
    with costs:
        fn()
    return costs.record()


def lm_component_costs(arch: ArchSpec, shape: ShapeSpec, mesh, multi_pod: bool,
                       opt_cfg: AdamWConfig | None = None, rules: dict | None = None) -> dict:
    """Per-device ``{flops, bytes, collective_bytes}`` of each part of an LM
    cell (``{part: costs}``, the layer's with its multiplicity ``mult``),
    each part traced once on ``mesh`` under ``rules`` (default: the
    production rules of the cell). ``bytes`` is the unfused upper bound.
    The cell's totals are the whole step's (``dryrun.lm_costs``)."""
    from repro_torch.launch.steps import arch_rules, default_opt_cfg, lm_input_specs, lm_shape_config

    opt_cfg = opt_cfg or default_opt_cfg(arch)
    rules = arch_rules(arch, shape, multi_pod) if rules is None else rules
    cfg = lm_shape_config(arch, shape, multi_pod)
    B, S, d, L = shape.global_batch, shape.seq_len, cfg.d_model, cfg.n_layers
    dt = cfg.param_dtype
    parts: dict[str, dict] = {}
    one = dataclasses.replace(cfg, n_layers=1)
    freqs = tfm.rope_freqs(cfg.d_head, cfg.rope_theta).to("meta")
    with sharding_rules(rules), use_mesh(mesh):
        lp = place_tree(_layer_slice_specs(one), rules, mesh,
                        requires_grad=shape.kind == "train")
        lm_head = place_tree(tfm.param_specs(one)["lm_head"], rules, mesh,
                             requires_grad=shape.kind == "train")
        if shape.kind in ("train", "prefill"):
            xdt = torch.float32 if cfg.embed_scale else dt
            x_spec = ArraySpec((B, S, d), ("dp", "model_seq", "model_d"), xdt)
            positions = torch.arange(S, device="meta")[None, :]
            if shape.kind == "train":
                x = place_tree(x_spec, rules, mesh, requires_grad=True)
                ct = place_tree(x_spec, rules, mesh)

                def layer():
                    y = checkpoint(tfm._layer_out, x, lp, cfg, positions, freqs,
                                   use_reentrant=False)
                    y = tfm.constrain(y, "dp", "model_seq", "model_d")
                    y.backward(ct)

                parts["layer"] = _measure(layer, x, lp, ct)
                h = place_tree(x_spec, rules, mesh, requires_grad=True)
                tokens = place_tree(ArraySpec((B, S), ("dp", None), torch.int32), rules, mesh)

                def head():
                    tfm.lm_loss(lm_head, h, tokens, cfg).backward()

                parts["head"] = _measure(head, h, lm_head, tokens)
                table = place_tree(tfm.param_specs(one)["embed"], rules, mesh, requires_grad=True)

                def embed():
                    e = tfm.constrain(tfm.embed_rows(table, tokens, cfg),
                                      "dp", "model_seq", "model_d")
                    e.backward(ct)

                parts["embed"] = _measure(embed, table, tokens, ct)
                model = tfm.Transformer(cfg, device="meta")
                distribute_params(model, tfm.param_specs(cfg), rules, mesh)
                opt = AdamW(model.parameters(), opt_cfg)
                for p in model.parameters():
                    p.grad = torch.zeros_like(p)
                for p in model.parameters():  # the moments exist from step 1 on
                    opt.state[p]["m"] = torch.zeros_like(p, dtype=opt_cfg.moment_dtype)
                    opt.state[p]["v"] = torch.zeros_like(p, dtype=opt_cfg.moment_dtype)
                parts["opt"] = _measure(
                    lambda: opt.step(), list(model.parameters()),
                    [p.grad for p in model.parameters()],
                    [list(s.values()) for s in opt.state.values()])
                del model, opt
            else:
                x = place_tree(x_spec, rules, mesh)

                def layer():
                    with torch.no_grad():
                        y, _, _ = tfm._layer(x, lp, cfg, positions, freqs)
                        tfm.constrain(y, "dp", "model_seq", "model_d")

                parts["layer"] = _measure(layer, x, lp)
                last = place_tree(ArraySpec((B, d), ("dp", None), xdt), rules, mesh)

                def head():
                    with torch.no_grad():
                        tfm.head_logits(lm_head, last, cfg, softcap=False)

                parts["head"] = _measure(head, last, lm_head)
        else:  # decode
            cache = {k: ArraySpec(s.shape[1:], s.logical[1:], s.dtype)
                     for k, s in lm_input_specs(arch, shape)["cache"].items()}
            kc, vc = (place_tree(cache[k], rules, mesh) for k in ("k", "v"))
            xdt = torch.float32 if cfg.embed_scale else dt
            xd = place_tree(ArraySpec((B, 1, d), ("cache_batch", None, None), xdt), rules, mesh)

            def layer():
                with torch.no_grad():
                    tfm.decode_layer(xd, lp, kc, vc, S - 1, cfg, freqs)

            parts["layer"] = _measure(layer, xd, lp, kc, vc)
            last = place_tree(ArraySpec((B, d), ("cache_batch", None), xdt), rules, mesh)

            def head():
                with torch.no_grad():
                    tfm.head_logits(lm_head, last, cfg, batch="cache_batch")

            parts["head"] = _measure(head, last, lm_head)
    parts["layer"]["mult"] = L
    return parts
