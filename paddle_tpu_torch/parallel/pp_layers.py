"""Pipeline layer segmentation.

Counterpart of `paddle_tpu/parallel/pp_layers.py` (:15-122): `LayerDesc`,
`SharedLayerDesc` and `PipelineLayer`, which declares a model as a flat
list of descs segmented into `num_stages` x `num_virtual_pipeline_stages`
contiguous chunks (`seg_method` "uniform" or "layer:<Class>"), chain chunk
c on physical stage `chunk_to_stage(c)` = c % num_stages.

In a process world whose hybrid topology has pp > 1, a PipelineLayer
builds only the entries of the rank's stage (`get_stage_id()`): the
segment bounds follow from the descs alone, and a model the size of
config 5's does not fit one card whole. Its parameter names keep the
entry's index (`"3.attention.qkv.weight"`), so a whole state dict loads
into any stage (`set_state_dict` takes the stage's keys). Its init draws
then differ from the single controller's; parity runs load one state into
both. A `SharedLayerDesc` whose key appears in more than one stage raises
there (ROADMAP.md Queue 1, "SharedLayerDesc across processes"); the
single controller keeps the reference's behaviour (the shared layer is
one object in every stage that holds it).
"""
from __future__ import annotations

from typing import List, Optional

from ..nn.layer.container import Sequential
from ..nn.layer.layers import Layer


class LayerDesc:
    def __init__(self, layer_func, *inputs, **kwargs):
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_func(*self.inputs, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    def __init__(self, key, layer_func, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


def _class_name(entry) -> str:
    if isinstance(entry, LayerDesc):
        f = entry.layer_func
        return f.__name__ if isinstance(f, type) else type(f).__name__
    if isinstance(entry, Layer):
        return type(entry).__name__
    return "_FnLayer"


def _world_stage():
    """(pp degree, this rank's stage) of a process world with pp > 1, or
    None."""
    from .topology import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    if hcg is None or not getattr(hcg, "process_mode", False) or \
            hcg.pp_degree <= 1:
        return None
    return hcg.pp_degree, hcg.get_stage_id()


class PipelineLayer(Layer):
    """Declares the full model as a flat list of LayerDescs, segmented into
    `num_stages` contiguous stages (uniform or by layer class)."""

    def __init__(self, layers: List, num_stages: Optional[int] = None,
                 topology=None, loss_fn=None, seg_method="uniform",
                 recompute_interval=0, recompute_ctx=None,
                 num_virtual_pipeline_stages=1):
        super().__init__()
        self.descs = list(layers)
        world = _world_stage()
        self.num_stages = num_stages or (world[0] if world else 1)
        self.num_virtual_stages = max(int(num_virtual_pipeline_stages), 1)
        self.loss_fn = loss_fn
        self.seg_method = seg_method
        self._built_layers: List = []
        self._shared = {}
        self._build()

    def _local_entries(self):
        """The entry indices this process builds: all of them, or in a
        process world with pp > 1 those of the rank's stage."""
        world = _world_stage()
        if world is None:
            return set(range(len(self.descs))), None
        stage = world[1]
        mine = set()
        for c, (lo, hi) in enumerate(self.segments):
            if self.chunk_to_stage(c) == stage:
                mine.update(range(lo, hi))
        return mine, stage

    def _build(self):
        """Segment, then build the entries this process holds."""
        for name in [n for n in self._modules if n.isdigit()]:
            del self._modules[name]
        self._segment()
        mine, stage = self._local_entries()
        if stage is not None:
            owners = {}
            for c, (lo, hi) in enumerate(self.segments):
                for i in range(lo, hi):
                    d = self.descs[i]
                    if isinstance(d, SharedLayerDesc):
                        owners.setdefault(d.layer_name, set()).add(
                            self.chunk_to_stage(c))
            shared = sorted(k for k, s in owners.items() if len(s) > 1)
            if shared:
                raise NotImplementedError(
                    f"SharedLayerDesc {shared} spans stages "
                    f"{sorted(owners[shared[0]])} across processes: tying "
                    "weights over the pp group is not ported (ROADMAP.md "
                    "Queue 1, \"SharedLayerDesc across processes\")")
        self._built_layers = [None] * len(self.descs)
        self._shared = {}
        for i, d in enumerate(self.descs):
            if i not in mine:
                continue
            if isinstance(d, SharedLayerDesc):
                layer = self._shared.get(d.layer_name)
                if layer is None:
                    layer = self._shared[d.layer_name] = d.build_layer()
            elif isinstance(d, LayerDesc):
                layer = d.build_layer()
            elif isinstance(d, Layer):
                layer = d
            elif callable(d):
                layer = _FnLayer(d)
            else:
                raise TypeError(f"bad pipeline entry {d!r}")
            self._built_layers[i] = layer
            self.add_sublayer(str(i), layer)

    def _segment(self):
        n = len(self.descs)
        k = self.num_stages * self.num_virtual_stages
        if self.seg_method.startswith("layer:"):
            # split at the entries whose class name matches
            cls_name = self.seg_method.split(":", 1)[1]
            marks = [i for i, d in enumerate(self.descs)
                     if _class_name(d) == cls_name]
            per = max(1, len(marks) // k)
            bounds = [0]
            for s in range(1, k):
                bounds.append(marks[min(s * per, len(marks) - 1)])
            bounds.append(n)
        else:
            # balanced split (i*n//k): slack spreads across chunks
            bounds = [i * n // k for i in range(k + 1)]
        self.segments = [(bounds[i], bounds[i + 1]) for i in range(k)]

    def resegment(self, num_stages: int):
        """Set `num_stages` and segment again (`fleet.distributed_model`);
        in a process world the rank's stage is built anew."""
        self.num_stages = int(num_stages)
        if _world_stage() is not None:
            self._build()
        else:
            self._segment()

    def get_stage_module(self, stage: int) -> Sequential:
        lo, hi = self.segments[stage]
        layers = self._built_layers[lo:hi]
        if any(layer is None for layer in layers):
            raise RuntimeError(f"PipelineLayer: chunk {stage} is another "
                               "rank's stage")
        return Sequential(*layers)

    def get_stage_modules(self) -> List[Sequential]:
        """Chunks in CHAIN order (logical pipeline position); with virtual
        stages there are num_stages * V of them."""
        return [self.get_stage_module(s) for s in range(len(self.segments))]

    def chunk_to_stage(self, chunk: int) -> int:
        """Physical stage owning chain chunk `chunk`."""
        return chunk % self.num_stages

    def forward(self, x):
        for layer in self._built_layers:
            if layer is not None:
                x = layer(x)
        return x


class _FnLayer(Layer):
    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def forward(self, *args):
        return self._fn(*args)


__all__ = ["LayerDesc", "SharedLayerDesc", "PipelineLayer"]
