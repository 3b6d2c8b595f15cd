"""paddle.static.nn: structured control flow and the legacy layer builders.

Counterpart of `paddle_tpu/static/nn.py` (:1-683). The four control-flow
functions (`cond`, `while_loop`, `case`, `switch_case`, :33-86) keep plain
Python semantics on Python values and concrete tensors, and lower to
torch's `cond` and `while_loop` operators on the tensors of an export
trace (`torch.export`, which `jit.to_static` and `static.Program` use),
as the reference lowers to `lax.cond` / `lax.while_loop`.

The operators are called directly, not through `torch.cond`, whose
dynamo pass cannot trace the port's `Tensor`. Their branch and body
functions must then take every traced tensor they read as an operand, so
each call first runs its functions once on the trace's fake tensors with
recording off (`_probe`) and collects the fake tensors they read that
they did not make (`_Collect`); those become the operator's operands,
and while the operator traces a function a `_Swap` mode hands it the
operands in their place. The functions may close over anything, as
`lax.cond`'s may. Outputs that alias an operand or a view are copied: the
operators take no aliased outputs.

The builders (`fc`, `batch_norm`, `conv2d`, ..., :89-683) make the
matching `nn` Layer in a module-level scope keyed by `param_attr.name` (a
named attr shares its parameters across calls, the reference's reuse
mechanism; unnamed calls get fresh ones under a unique name) and run it
at once. The `sequence_*` names bind to `ops/sequence.py`'s padded-dense
+ lengths forms.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch._subclasses.fake_tensor import is_fake
from torch.overrides import TorchFunctionMode

from ..core.tensor import Parameter, Tensor, to_torch
from ..jit.dy2static import _is_traced

__all__ = [
    "fc", "batch_norm", "embedding", "bilinear_tensor_product", "case",
    "cond", "conv2d", "conv2d_transpose", "conv3d", "conv3d_transpose",
    "crf_decoding", "data_norm", "deform_conv2d", "group_norm",
    "instance_norm", "layer_norm", "multi_box_head", "nce", "prelu",
    "py_func", "row_conv", "spectral_norm", "switch_case", "while_loop",
    "sparse_embedding", "sequence_conv", "sequence_softmax",
    "sequence_pool", "sequence_concat", "sequence_first_step",
    "sequence_last_step", "sequence_slice", "sequence_expand",
    "sequence_expand_as", "sequence_pad", "sequence_unpad",
    "sequence_reshape", "sequence_scatter", "sequence_enumerate",
    "sequence_reverse"]


# ---- lifting what a branch reads into the operator's operands ----

def _probe(fn):
    """fn() run without recording into the trace underway (its ops run on
    the fake tensors and leave no node); outside a trace, fn()."""
    from torch.fx.experimental.proxy_tensor import disable_proxy_modes_tracing
    with disable_proxy_modes_tracing():
        return fn()


# the operand maps of the operator functions being traced, outermost
# first: a branch nested in a branch reads the outer trace's tensors
# through every level's map
_SWAPS: list = []


def _resolve(t):
    for m in _SWAPS:
        t = m.get(id(t), t)
    return t


class _Collect(TorchFunctionMode):
    """Records the fake tensors that reach torch functions (or the
    block's outputs) without having been made by one inside the block (a
    real tensor read there is a constant of the trace)."""

    def __init__(self):
        super().__init__()
        self.made, self.free = set(), {}

    def note(self, tree):
        for a in pytree.tree_leaves(tree):
            if isinstance(a, torch.Tensor) and id(a) not in self.made:
                a = _resolve(a)
                if is_fake(a):
                    self.free.setdefault(id(a), a)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.note((args, kwargs))
        out = func(*args, **kwargs)
        for o in pytree.tree_leaves(out):
            if isinstance(o, torch.Tensor):
                self.made.add(id(o))
        return out


class _Swap(TorchFunctionMode):
    """Replaces the tensors of the active operand maps in every torch
    call's arguments."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        args, kwargs = pytree.tree_map_only(
            torch.Tensor, _resolve, (args, kwargs or {}))
        return func(*args, **kwargs)


def _free_tensors(thunks, exclude=()):
    """(the traced tensors the thunks read without making them, the
    thunks' results), the thunks run without recording."""
    col = _Collect()
    outs = []
    with col:
        for th in thunks:
            outs.append(_probe(th))
    for out in outs:     # an output passed through untouched is read too
        col.note(out)
    skip = {id(_resolve(t)) for t in exclude}
    return [t for i, t in col.free.items() if i not in skip], outs


def _scalar_tensor(v, like):
    """A Python number as a 0-d tensor on `like`'s device: a `full` op,
    not a tensor constant (the operators' subgraphs keep constants made
    inside a trace as fake tensors)."""
    dt = torch.bool if isinstance(v, bool) else torch.int32 \
        if isinstance(v, (int, np.integer)) else torch.float32
    return torch.full((), v, dtype=dt, device=like.device)


_DYN = object()     # a layout's slot for a tensor leaf


def _flat_out(out, like):
    """(tensor leaves, layout). Tensors go through the operator (`Tensor`s
    as plain aliases), Python numbers too as 0-d tensors (int32, float32,
    bool: the reference's weak types); any other leaf (None) is static,
    kept in the layout, and must be the same on every path."""
    leaves, spec = pytree.tree_flatten(out)
    flat, statics = [], []
    for v in leaves:
        if isinstance(v, torch.Tensor):
            flat.append(to_torch(v))
        elif isinstance(v, (bool, int, float, np.number)):
            flat.append(_scalar_tensor(v, like))
        else:
            statics.append(v)
            continue
        statics.append(_DYN)
    return flat, (spec, tuple(statics))


def _unflat(tensors, layout):
    spec, statics = layout
    it = iter(tensors)
    return pytree.tree_unflatten([next(it) if v is _DYN else v
                                  for v in statics], spec)


def _same_layout(a, b) -> bool:
    if a[0] != b[0] or len(a[1]) != len(b[1]):
        return False
    for x, y in zip(a[1], b[1]):
        if x is y:
            continue
        if x is _DYN or y is _DYN or type(x) is not type(y):
            return False
        try:
            if not bool(x == y):
                return False
        except Exception:  # noqa: BLE001 - incomparable: not the same
            return False
    return True


def _lifted(fn, free, like, n_args=0, single=False):
    """fn as a function of (*args, *free): while it runs, the operands
    stand in for the free tensors; its outputs come back flat (the one
    output bare with `single`), copied where they alias an operand, a
    view or each other."""
    def g(*ops):
        args, lifted = ops[:n_args], ops[n_args:]
        _SWAPS.append({id(f): o for f, o in zip(free, lifted)})
        try:
            with _Swap():
                out = fn(*args)
            flat, _ = _flat_out(out, like)
            flat = [_resolve(t) for t in flat]
        finally:
            _SWAPS.pop()
        seen, res = {id(o) for o in ops}, []
        for t in flat:
            if id(t) in seen or t._is_view():
                t = t.clone()
            seen.add(id(t))
            res.append(t)
        return res[0] if single else tuple(res)
    return g


def _pred(p):
    return to_torch(p).reshape(()).to(torch.bool)


def cond(pred, true_fn=None, false_fn=None, name=None, return_names=None):
    """true_fn() if pred else false_fn(); on a traced pred one `cond`
    operator over both branches, which must return the same structure of
    tensors of one shape and dtype each (else TypeError, as
    `lax.cond`)."""
    if not _is_traced(pred):
        return true_fn() if bool(pred) else false_fn()
    p = _pred(pred)
    free, (out_t, out_f) = _free_tensors([true_fn, false_fn])
    (ft, lt), (ff, lf) = _flat_out(out_t, p), _flat_out(out_f, p)
    if not _same_layout(lt, lf) or [(tuple(a.shape), a.dtype) for a in ft] \
            != [(tuple(b.shape), b.dtype) for b in ff]:
        raise TypeError(
            "static.nn.cond: the branches return different structures, "
            f"shapes or dtypes: {lt[0]} {[tuple(a.shape) for a in ft]} vs "
            f"{lf[0]} {[tuple(b.shape) for b in ff]}")
    from torch._higher_order_ops.cond import cond_op
    out = cond_op(p, _lifted(true_fn, free, p), _lifted(false_fn, free, p),
                  tuple(free))
    return _unflat(out, lt)


def while_loop(cond_fn, body_fn, loop_vars, is_test=False, name=None):
    """while cond_fn(*vars): vars = body_fn(*vars); returns the list of
    vars. With a traced test or carry, one `while_loop` operator: the
    body keeps each carried value's shape and dtype."""
    vs = list(loop_vars)
    c0 = _probe(lambda: cond_fn(*vs))
    if not (_is_traced(c0) or any(_is_traced(v) for v in vs)):
        while bool(cond_fn(*vs)):
            out = body_fn(*vs)
            vs = list(out) if isinstance(out, (list, tuple)) else [out]
        return vs
    like = c0 if isinstance(c0, torch.Tensor) else next(
        v for v in vs if isinstance(v, torch.Tensor))
    carried, layout = _flat_out(vs, like)

    def test(*args):
        return _pred(cond_fn(*_unflat(args, layout)))

    def body(*args):
        out = body_fn(*_unflat(args, layout))
        return list(out) if isinstance(out, (list, tuple)) else [out]

    free, (_, out) = _free_tensors(
        [lambda: test(*carried), lambda: body(*carried)], exclude=carried)
    if not _same_layout(_flat_out(out, like)[1], layout):
        raise TypeError("static.nn.while_loop: the body returns another "
                        "structure than the loop variables")
    from torch._higher_order_ops.while_loop import while_loop_op
    n = len(carried)
    res = while_loop_op(_lifted(test, free, like, n, single=True),
                        _lifted(body, free, like, n),
                        tuple(carried), tuple(free))
    return list(_unflat(res, layout))


def _switch(index, fns):
    """fns[index](): on a traced index a chain of `cond`s."""
    if not _is_traced(index):
        return fns[int(index)]()
    out = fns[-1]
    for i in range(len(fns) - 2, -1, -1):
        out = (lambda i=i, rest=out: cond(index == i, fns[i], rest))
    return out()


def case(pred_fn_pairs, default=None, name=None):
    """The fn of the first true pred; with none true, `default` (if given)
    else the first fn (the reference's argmax over the preds)."""
    preds = [p for p, _ in pred_fn_pairs]
    fns = [f for _, f in pred_fn_pairs]
    if default is not None:
        fns = fns + [default]
        preds = preds + [True]
    if not any(_is_traced(p) for p in preds):
        flags = [bool(p) for p in preds]
        return fns[flags.index(True) if True in flags else 0]()
    like = next(p for p in preds if _is_traced(p))
    stacked = torch.stack([_pred(p).to(torch.int32) if isinstance(
        p, torch.Tensor) else _scalar_tensor(int(bool(p)), like)
        for p in preds])
    return _switch(torch.argmax(stacked), fns)


def switch_case(branch_index, branch_fns, default=None, name=None):
    """The branch keyed by branch_index. A dict's keys are sorted and an
    unmatched index takes its first branch; with `default`, an index past
    the end (or below 0 after clipping) takes the default or the first
    branch — the reference's position arithmetic."""
    if isinstance(branch_fns, dict):
        keys = sorted(branch_fns)
        fns = [branch_fns[k] for k in keys]
        if _is_traced(branch_index):
            bi = to_torch(branch_index).reshape(())
            pos = sum(torch.where(bi == k, i, 0) for i, k in enumerate(keys))
        else:
            bi = int(branch_index)
            pos = sum(i for i, k in enumerate(keys) if bi == k)
    else:
        fns = list(branch_fns)
        pos = to_torch(branch_index).reshape(()) if _is_traced(
            branch_index) else int(branch_index)
    if default is not None:
        fns = fns + [default]
        pos = torch.clamp(pos, 0, len(fns) - 1) if isinstance(
            pos, torch.Tensor) else min(max(pos, 0), len(fns) - 1)
    return _switch(pos, fns)


# ---- legacy layer-builder functions (static/nn/common.py role) ----

_LAYER_SCOPE: dict = {}
_NAMES = {}


def _unique(kind):
    n = _NAMES.setdefault(kind, itertools.count())
    return f"{kind}_{next(n)}"


def _made_eagerly(kind):
    """A builder's layer is made at its first call, which must be eager:
    made inside an export its parameters would be the trace's (the
    reference fails there too, drawing its initial values from a
    tracer)."""
    if torch.compiler.is_exporting():
        raise RuntimeError(
            f"static.nn: the {kind} builder makes its layer at its first "
            "call; call it once eagerly before to_static captures it")


def _scoped_layer(kind, name, factory):
    if name is None:
        _made_eagerly(kind)
        layer = factory()
        _LAYER_SCOPE[_unique(kind)] = layer
        return layer
    key = f"{kind}:{name}"
    layer = _LAYER_SCOPE.get(key)
    if layer is None:
        _made_eagerly(kind)
        layer = _LAYER_SCOPE[key] = factory()
    return layer


def _scoped_param(key, make):
    """A Parameter kept in the scope under `key`, made from `make()` (a
    float32 numpy array) on the current device at its first use."""
    p = _LAYER_SCOPE.get(key)
    if p is None:
        _made_eagerly(key.split(":")[0])
        from ..core.place import resolve_device
        p = _LAYER_SCOPE[key] = Parameter(
            torch.from_numpy(make()).to(resolve_device()))
    return p


def _attr_name(attr):
    return getattr(attr, "name", None) if attr is not None else None


def _wrap(x):
    """A tensor argument: tensors as they are, other data as a `Tensor`."""
    if isinstance(x, torch.Tensor):
        return x
    from ..ops.creation import to_tensor
    return to_tensor(x)


def _maybe_act(out, act):
    if not act:
        return out
    from ..nn import functional as F
    return getattr(F, act)(out)


def _finish(out, *inputs):
    """out as a `Tensor` when an input was one (the boundary rule)."""
    if any(type(x) is Tensor for x in inputs) and type(out) is torch.Tensor:
        return out.as_subclass(Tensor)
    return out


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    """Fully-connected builder: flattens the dims from num_flatten_dims
    and applies a scoped Linear; a named weight_attr shares it."""
    from .. import nn
    xt = _wrap(x)
    d = int(np.prod(xt.shape[num_flatten_dims:]))
    lin = _scoped_layer("fc", _attr_name(weight_attr) or name,
                        lambda: nn.Linear(d, size,
                                          bias_attr=None if bias_attr
                                          is not False else False))
    flat = xt.reshape(list(xt.shape[:num_flatten_dims]) + [d])
    return _maybe_act(lin(flat), activation)


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None, do_model_average_for_mean_and_var=True,
               use_global_stats=False):
    from .. import nn
    x = _wrap(input)
    c = x.shape[1] if data_layout == "NCHW" else x.shape[-1]
    bn = _scoped_layer("batch_norm", _attr_name(param_attr) or name,
                       lambda: nn.BatchNorm2D(c, momentum=momentum,
                                              epsilon=epsilon)
                       if x.ndim == 4 else nn.BatchNorm1D(c))
    bn.training = not (is_test or use_global_stats)
    return _maybe_act(bn(x), act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """A scoped Embedding. `is_sparse` is accepted and its gradient is
    the dense one (the reference's SelectedRows gradient densified: the
    same values); the sparse form waits for `core/selected_rows.py`."""
    from .. import nn
    emb = _scoped_layer("embedding", _attr_name(param_attr),
                        lambda: nn.Embedding(size[0], size[1],
                                             padding_idx=padding_idx))
    return emb(_wrap(input))


def sparse_embedding(input, size, padding_idx=None, is_test=False,
                     entry=None, table_class="MemorySparseTable",
                     param_attr=None, dtype="float32"):
    """The PS-backed embedding's surface: `embedding(is_sparse=True)`."""
    return embedding(input, size, is_sparse=True, padding_idx=padding_idx,
                     param_attr=param_attr, dtype=dtype)


def _convnd(nd, transpose, input, num_filters, filter_size, stride=1,
            padding=0, dilation=1, groups=1, param_attr=None, bias_attr=None,
            use_cudnn=True, act=None, name=None, output_size=None,
            data_format=None):
    from .. import nn
    x = _wrap(input)
    cin = x.shape[1]
    cls = {(2, False): nn.Conv2D, (2, True): nn.Conv2DTranspose,
           (3, False): nn.Conv3D, (3, True): nn.Conv3DTranspose}[(nd, transpose)]
    kw = dict(stride=stride, padding=padding, dilation=dilation,
              groups=groups or 1)
    conv = _scoped_layer(f"conv{nd}d{'T' if transpose else ''}",
                         _attr_name(param_attr) or name,
                         lambda: cls(cin, num_filters, filter_size,
                                     bias_attr=False if bias_attr is False
                                     else None, **kw))
    return _maybe_act(conv(x), act)


def conv2d(*a, **kw):
    return _convnd(2, False, *a, **kw)


def conv2d_transpose(*a, **kw):
    return _convnd(2, True, *a, **kw)


def conv3d(*a, **kw):
    return _convnd(3, False, *a, **kw)


def conv3d_transpose(*a, **kw):
    return _convnd(3, True, *a, **kw)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    from .. import nn
    x = _wrap(input)
    shape = [int(np.prod(x.shape[begin_norm_axis:]))]
    ln = _scoped_layer("layer_norm", _attr_name(param_attr) or name,
                       lambda: nn.LayerNorm(shape, epsilon=epsilon))
    flat = x.reshape(list(x.shape[:begin_norm_axis]) + shape)
    return _maybe_act(ln(flat).reshape(list(x.shape)), act)


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, data_layout="NCHW", name=None):
    from .. import nn
    x = _wrap(input)
    gn = _scoped_layer("group_norm", _attr_name(param_attr) or name,
                       lambda: nn.GroupNorm(groups, x.shape[1],
                                            epsilon=epsilon))
    return _maybe_act(gn(x), act)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    from .. import nn
    x = _wrap(input)
    inorm = _scoped_layer("instance_norm", _attr_name(param_attr) or name,
                          lambda: nn.InstanceNorm2D(x.shape[1],
                                                    epsilon=epsilon))
    return inorm(x)


def data_norm(input, act=None, epsilon=1e-5, param_attr=None,
              data_layout="NCHW", in_place=False, name=None,
              moving_mean_name=None, moving_variance_name=None,
              do_model_average_for_mean_and_var=True, slot_dim=-1,
              sync_stats=False, summary_decay_rate=0.9999999,
              enable_scale_and_shift=False):
    """CTR data normalisation: the features over the batch's mean and
    (population) variance, no learned affine."""
    x = _wrap(input)
    a = to_torch(x)
    mu = a.mean(dim=0, keepdim=True)
    var = a.var(dim=0, unbiased=False, keepdim=True)
    return _maybe_act(_finish((a - mu) / torch.sqrt(var + epsilon), x), act)


def prelu(x, mode="all", param_attr=None, data_format="NCHW", name=None):
    from .. import nn
    xt = _wrap(x)
    n = 1 if mode == "all" else (xt.shape[1] if mode == "channel"
                                 else int(xt.shape[-1]))
    pr = _scoped_layer("prelu", _attr_name(param_attr) or name,
                       lambda: nn.PReLU(num_parameters=n))
    return pr(xt)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """weight / sigma, sigma by `power_iters` power iterations from a
    seeded start vector (RandomState(0), as the reference)."""
    from ..nn.utils import spectral_normalize
    w = _wrap(weight)
    h = int(w.shape[dim])
    u0 = np.random.RandomState(0).randn(h).astype("float32")
    out, _, _ = spectral_normalize(to_torch(w), u0 / np.linalg.norm(u0),
                                   dim=dim, n_power_iterations=power_iters,
                                   eps=eps)
    return _finish(out, w)


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    from .. import nn
    xt, yt = _wrap(x), _wrap(y)
    bl = _scoped_layer("bilinear", _attr_name(param_attr) or name,
                       lambda: nn.Bilinear(xt.shape[-1], yt.shape[-1], size))
    return _maybe_act(bl(xt, yt), act)


def row_conv(input, future_context_size, param_attr=None, act=None):
    """Lookahead row convolution: out[t] = sum_{i=0..k} w[i] * x[t+i] per
    feature channel; the weight [k + 1, D] is drawn from RandomState(0)
    uniform(-0.1, 0.1), as the reference's."""
    x = _wrap(input)                      # [B, T, D]
    k = future_context_size + 1
    d = int(x.shape[-1])
    w = _scoped_param(f"row_conv:{_attr_name(param_attr) or id(d)}:{k}",
                      lambda: np.random.RandomState(0).uniform(
                          -0.1, 0.1, (k, d)).astype("float32"))
    a = to_torch(x)
    ap = torch.nn.functional.pad(a, (0, 0, 0, k - 1))
    out = torch.zeros_like(a)
    for i in range(k):
        out = out + ap[:, i:i + a.shape[1]] * w[i][None, None, :]
    return _maybe_act(_finish(out, x), act)


def nce(input, label, num_total_classes, sample_weight=None, param_attr=None,
        bias_attr=None, num_neg_samples=None, name=None, sampler="uniform",
        custom_dist=None, seed=0, is_sparse=False):
    """Noise-contrastive estimation loss [B, 1]: one positive and
    `num_neg_samples` uniform negatives per example, logistic loss. The
    negatives are drawn afresh each call from the random ops' generator;
    the class weights [C, D] from RandomState(seed) / sqrt(D), as the
    reference's."""
    from ..core.random import op_generator
    x = _wrap(input)                      # [B, D]
    a = to_torch(x)
    d = int(a.shape[-1])
    n_neg = int(num_neg_samples or 10)
    w = _scoped_param(f"nce:{_attr_name(param_attr) or d}:{num_total_classes}",
                      lambda: (np.random.RandomState(seed).randn(
                          num_total_classes, d) / np.sqrt(d)).astype(
                              "float32"))
    negs = torch.randint(0, num_total_classes, (int(a.shape[0]), n_neg),
                         generator=op_generator(a.device), device=a.device)
    ids = to_torch(_wrap(label)).reshape(-1).long()
    pos_logit = torch.sum(a * w[ids], -1)
    neg_logit = torch.einsum("bd,bkd->bk", a, w[negs])
    sp = torch.nn.functional.softplus
    loss = sp(-pos_logit) + sp(neg_logit).sum(-1)
    return _finish(loss[:, None], x)


def crf_decoding(input, param_attr=None, label=None, length=None,
                 transition=None):
    """Viterbi decoding under linear-chain CRF transitions [N + 2, N]
    (rows 0 / 1 start / stop, the rest N x N; drawn from RandomState(0)
    x 0.1 unless given). Returns the [B, T] best path (int32), or with
    `label` the per-position correctness mask."""
    x = _wrap(input)                           # [B, T, N]
    p = to_torch(x).detach()
    n = int(p.shape[-1])
    if transition is not None:
        t = to_torch(_wrap(transition))
    else:
        t = _scoped_param(f"crf_trans:{_attr_name(param_attr) or n}",
                          lambda: (np.random.RandomState(0).randn(n + 2, n)
                                   * 0.1).astype("float32"))
    t = t.detach()
    b, steps = int(p.shape[0]), int(p.shape[1])
    lens = to_torch(_wrap(length)).reshape(-1).long() if length is not None \
        else torch.full((b,), steps, dtype=torch.long, device=p.device)
    start, stop, tr = t[0], t[1], t[2:]
    alpha = start[None] + p[:, 0]
    bps = []
    for s in range(1, steps):
        sc = alpha[:, :, None] + tr[None]
        bps.append(torch.argmax(sc, dim=1))
        live = (s < lens)[:, None]
        alpha = torch.where(live, torch.amax(sc, dim=1) + p[:, s], alpha)
    alpha = alpha + stop[None]
    tag = torch.argmax(alpha, -1)
    path = [tag]
    for s in range(steps - 1, 0, -1):
        prev = torch.gather(bps[s - 1], 1, tag[:, None])[:, 0]
        tag = torch.where(s < lens, prev, tag)
        path.append(tag)
    out = torch.stack(path[::-1], dim=1).to(torch.int32)
    if label is not None:
        out = (out == to_torch(_wrap(label)).to(torch.int32)).to(torch.int32)
    return _finish(out, x)


_PY_FUNCS = {}
_PY_FUNC_IDS = itertools.count()
_PY_FUNC_OP = []


def _py_func_op():
    """The `paddle_tpu_torch::py_func` operator (registered at first use):
    an exported graph calls the host function `_PY_FUNCS[fid]` through
    it, with the output specs that function was registered with."""
    if _PY_FUNC_OP:
        return _PY_FUNC_OP[0]

    @torch.library.custom_op("paddle_tpu_torch::py_func", mutates_args=())
    def py_func_op(xs: list[torch.Tensor], fid: int) -> list[torch.Tensor]:
        fn, specs = _PY_FUNCS[fid]
        r = fn(*[a.detach().cpu().numpy() for a in xs])
        r = r if isinstance(r, (list, tuple)) else [r]
        dev = xs[0].device if xs else torch.device("cpu")
        return [torch.as_tensor(np.asarray(v, dtype=dt), device=dev)
                for v, (_, dt) in zip(r, specs)]

    @py_func_op.register_fake
    def _(xs, fid):
        _, specs = _PY_FUNCS[fid]
        dev = xs[0].device if xs else torch.device("cpu")
        return [torch.empty(shape, dtype=torch.from_numpy(
            np.zeros(0, dt)).dtype, device=dev) for shape, dt in specs]

    _PY_FUNC_OP.append(torch.ops.paddle_tpu_torch.py_func)
    return _PY_FUNC_OP[0]


def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None):
    """A host Python op: `func` on the inputs' numpy values. Eagerly it is
    called at once; in an export trace it becomes one
    `paddle_tpu_torch::py_func` node that calls it with the declared `out`
    specs (shape and dtype), as the reference's `jax.pure_callback`. The
    node holds an id of this process's registry: a program that holds one
    runs in this process only, as the reference's callback."""
    xs = x if isinstance(x, (list, tuple)) else [x]
    arrs = [to_torch(_wrap(a)) for a in xs]
    outs_spec = out if isinstance(out, (list, tuple)) else [out]
    if any(_is_traced(a) for a in arrs):
        fid = next(_PY_FUNC_IDS)
        specs = [(tuple(int(d) for d in o.shape),
                  np.dtype(str(o.dtype).replace("torch.", "")))
                 for o in outs_spec]
        _PY_FUNCS[fid] = (func, specs)
        outs = list(_py_func_op()(arrs, fid))
    else:
        from ..ops._dispatch import from_data
        r = func(*[a.detach().cpu().numpy() for a in arrs])
        r = r if isinstance(r, (list, tuple)) else [r]
        dev = arrs[0].device if arrs else None
        outs = [from_data(np.asarray(v), device=dev).as_subclass(Tensor)
                for v in r]
    return outs[0] if not isinstance(out, (list, tuple)) else outs


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None):
    """SSD detection head: per feature map a conv predicts box offsets and
    class scores against generated priors. Returns (locs [B, P, 4], confs
    [B, P, C], boxes [P, 4], variances [P, 4])."""
    from .. import nn
    from ..ops.manipulation import concat
    locs, confs, boxes, vars_ = [], [], [], []
    n_in = len(inputs)
    if min_sizes is None:
        min_ratio, max_ratio = min_ratio or 20, max_ratio or 90
        step = int((max_ratio - min_ratio) / max(n_in - 2, 1))
        min_sizes, max_sizes = [], []
        for r in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * r / 100.0)
            max_sizes.append(base_size * (r + step) / 100.0)
        min_sizes = [base_size * 0.1] + min_sizes[:n_in - 1]
        max_sizes = [base_size * 0.2] + max_sizes[:n_in - 1]
    img = _wrap(image)
    for i, feat in enumerate(inputs):
        f = _wrap(feat)
        ar = aspect_ratios[i] if isinstance(aspect_ratios[i], (list, tuple)) \
            else [aspect_ratios[i]]
        # priors per cell: the min box, sqrt(min * max) with max_sizes, and
        # one box per non-1 aspect ratio (two when flipped)
        n_ar = len([a for a in ar if a != 1])
        n_prior = 1 + (1 if max_sizes else 0) + n_ar * (2 if flip else 1)
        loc_conv = _scoped_layer(f"mbox_loc{i}", None,
                                 lambda f=f, n=n_prior: nn.Conv2D(
                                     f.shape[1], n * 4, kernel_size,
                                     padding=pad, stride=stride))
        conf_conv = _scoped_layer(f"mbox_conf{i}", None,
                                  lambda f=f, n=n_prior: nn.Conv2D(
                                      f.shape[1], n * num_classes,
                                      kernel_size, padding=pad,
                                      stride=stride))
        loc = loc_conv(f)
        conf = conf_conv(f)
        b = loc.shape[0]
        locs.append(to_torch(loc).permute(0, 2, 3, 1).reshape(b, -1, 4))
        confs.append(to_torch(conf).permute(0, 2, 3, 1).reshape(
            b, -1, num_classes))
        fh, fw = int(f.shape[2]), int(f.shape[3])
        ih, iw = int(img.shape[2]), int(img.shape[3])
        sw = steps[i] if steps else iw / fw
        sh = steps[i] if steps else ih / fh
        pri = []
        for yy, xx in itertools.product(range(fh), range(fw)):
            cx, cy = (xx + offset) * sw, (yy + offset) * sh
            sizes = [(min_sizes[i], min_sizes[i])]
            if max_sizes:
                s = np.sqrt(min_sizes[i] * max_sizes[i])
                sizes.append((s, s))
            for a in ar:
                if a == 1:
                    continue
                sizes.append((min_sizes[i] * np.sqrt(a),
                              min_sizes[i] / np.sqrt(a)))
                if flip:
                    sizes.append((min_sizes[i] / np.sqrt(a),
                                  min_sizes[i] * np.sqrt(a)))
            for bw, bh in sizes:
                box = [(cx - bw / 2) / iw, (cy - bh / 2) / ih,
                       (cx + bw / 2) / iw, (cy + bh / 2) / ih]
                if clip:
                    box = [min(max(v, 0.0), 1.0) for v in box]
                pri.append(box)
        boxes.append(np.asarray(pri, "float32"))
        vars_.append(np.tile(np.asarray(variance, "float32"), (len(pri), 1)))
    dev = locs[0].device
    mbox_locs = concat([t.as_subclass(Tensor) for t in locs], axis=1)
    mbox_confs = concat([t.as_subclass(Tensor) for t in confs], axis=1)
    box = torch.from_numpy(np.concatenate(boxes, 0)).to(dev)
    var = torch.from_numpy(np.concatenate(vars_, 0)).to(dev)
    return mbox_locs, mbox_confs, box.as_subclass(Tensor), \
        var.as_subclass(Tensor)


# sequence_* over the padded-dense + lengths forms of ops/sequence.py
from ..ops.sequence import (  # noqa: E402,F401
    sequence_pad, sequence_unpad, sequence_pool, sequence_expand,
    sequence_softmax,
)


def sequence_first_step(input, lengths=None):
    x = _wrap(input)
    return x[:, 0]


def sequence_last_step(input, lengths=None):
    x = _wrap(input)
    if lengths is None:
        return x[:, -1]
    a = to_torch(x)
    idx = (to_torch(_wrap(lengths)).long() - 1).clamp(min=0)
    out = torch.take_along_dim(
        a, idx.reshape((-1, 1) + (1,) * (a.ndim - 2)), dim=1)[:, 0]
    return _finish(out, x)


def sequence_concat(inputs, name=None):
    from ..ops.manipulation import concat
    return concat([_wrap(i) for i in inputs], axis=1)


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=True, padding_start=None, bias_attr=None,
                  param_attr=None, act=None, name=None):
    """Sequence convolution over time: a 1-D conv across the padded time
    axis."""
    from .. import nn
    x = _wrap(input)                      # [B, T, D]
    conv = _scoped_layer("sequence_conv", _attr_name(param_attr) or name,
                         lambda: nn.Conv1D(x.shape[-1], num_filters,
                                           filter_size,
                                           padding=(filter_size - 1) // 2
                                           if padding else 0))
    out = conv(to_torch(x).transpose(1, 2))
    return _maybe_act(_finish(to_torch(out).transpose(1, 2), x), act)


def sequence_slice(input, offset, length, name=None):
    """Per row, `length` steps from `offset` (padded with zeros up to the
    longest length)."""
    x = _wrap(input)
    a = to_torch(x)
    off = to_torch(_wrap(offset)).reshape(-1).long()
    ln = to_torch(_wrap(length)).reshape(-1).long()
    width = int(ln.max())
    ar = torch.arange(width, device=a.device)
    idx = torch.clamp(off[:, None] + ar[None, :], max=a.shape[1] - 1)
    mask = ar[None, :] < ln[:, None]
    if a.ndim == 3:
        out = torch.take_along_dim(a, idx[..., None], dim=1) * mask[..., None]
    else:
        out = torch.take_along_dim(a, idx, dim=1) * mask
    return _finish(out, x)


def sequence_expand_as(x, y, name=None):
    from ..ops.sequence import sequence_expand as _se
    return _se(_wrap(x), _wrap(y))


def sequence_reshape(input, new_dim):
    x = _wrap(input)
    b, t, d = x.shape
    return x.reshape([b, (t * d) // new_dim, new_dim])


def sequence_scatter(input, index, updates, name=None):
    """input[b, index[b, j]] += updates[b, j]."""
    x, upd = _wrap(input), _wrap(updates)
    a = to_torch(x)
    iv = to_torch(_wrap(index)).long()
    rows = torch.arange(a.shape[0], device=a.device)[:, None].expand_as(iv)
    out = a.index_put((rows, iv), to_torch(upd), accumulate=True)
    return _finish(out, x)


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    """[B, T] -> [B, T, win_size]: the window of win_size ids from each
    position, padded with pad_value past the end."""
    x = _wrap(input)
    a = to_torch(x)
    cols = [torch.nn.functional.pad(a[:, w:], (0, w), value=pad_value)
            if w else a for w in range(win_size)]
    return _finish(torch.stack(cols, dim=-1), x)


def sequence_reverse(x, name=None):
    xt = _wrap(x)
    return _finish(torch.flip(to_torch(xt), dims=[1]), xt)


def deform_conv2d(x, offset, mask, num_filters, filter_size, stride=1,
                  padding=0, dilation=1, groups=1, deformable_groups=1,
                  im2col_step=1, weight_attr=None, bias_attr=None, name=None):
    """A deformable conv builder over vision.ops.deform_conv2d with a
    scoped weight, drawn from RandomState(0) uniform(+-1/sqrt(fan_in))."""
    from ..vision.ops import deform_conv2d as _dc
    xt = _wrap(x)
    kh = filter_size if isinstance(filter_size, int) else filter_size[0]
    kw = filter_size if isinstance(filter_size, int) else filter_size[1]
    cin = int(xt.shape[1]) // groups
    k = 1.0 / np.sqrt(cin * kh * kw)
    w = _scoped_param(
        f"deform_conv2d:{_attr_name(weight_attr) or id(num_filters)}",
        lambda: np.random.RandomState(0).uniform(
            -k, k, (num_filters, cin, kh, kw)).astype("float32"))
    return _dc(xt, _wrap(offset), w, None, stride, padding, dilation,
               deformable_groups, groups, mask)
