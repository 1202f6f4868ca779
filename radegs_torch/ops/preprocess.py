"""The preprocess of a view, from the state's raw tensors to the rasterizer's
per-Gaussian inputs: the CUDA kernel ``csrc/preprocess_fwd.cu`` behind
``preprocess_forward``, its gradient ``csrc/preprocess_bwd.cu`` behind
``preprocess_backward``, the two joined as a ``torch.autograd.Function`` in
``preprocess_train`` for views on a card that a gradient flows from, and
their plain PyTorch version ``preprocess_torch`` (the state's getters —
fused filtered scales and opacity, normalised rotation, the SH features —
and ``core/projection.preprocess_gaussians``), which autograd
differentiates on the CPU.

The kernel writes one (P, 24) float32 table in the forward blend's column
order (``ops/blend.py`` ``pack_features``, ``N_FEAT``) beside ``radius``,
``valid``, ``well_conditioned`` and, asked, ``invraycov``; the
``PreprocessOut`` it returns holds views of that table (``from_table``).
Its table differs from the plain version's fields where nothing reads them:
the opacity column is 0 on rows that are not valid (the blend and the
integrate kernels zero those themselves), and an inactive row is zeros.

The backward kernel takes the incoming gradient of each field where autograd
hands it over (pointers and strides; an absent one reads as zero) and writes
the gradients of the six parameter tensors in their own layouts: the
gradient autograd takes through the plain version on every active row (the
opacity's as if the column were ``opacity * coef`` there too), zeros on an
inactive one.
"""

from __future__ import annotations

import ctypes

import torch

from radegs_torch.core.projection import PreprocessOut, preprocess_gaussians
from radegs_torch.models.gaussian_model import GaussianParams
from radegs_torch.native import build
from radegs_torch.ops.blend import N_FEAT
from radegs_torch.utils import trace
from radegs_torch.utils.device import on_device

# the columns of the table (pack_features' order); camera_plane's two
# columns are [:, :, 0] at 15:18 and [:, :, 1] at 18:21
COLUMNS = {"xy": slice(0, 2), "conic": slice(2, 5), "opacity": 5, "rgb": slice(6, 9),
           "ts": 9, "ray_plane": slice(10, 12), "view_point": slice(12, 15),
           "camera_plane": slice(15, 21), "normal": slice(21, 24)}
DEPTH = 14  # view_point's z
MAX_SH_DEGREE = 3

# the differentiable fields, in the backward kernel's order of incoming
# gradients, with the number of dimensions of each
GRAD_FIELDS = (("xy", 2), ("depth", 1), ("view_point", 2), ("conic", 2), ("opacity", 1),
               ("rgb", 2), ("camera_plane", 3), ("ray_plane", 2), ("normal", 2), ("ts", 1))

# kernel launches per SH degree (the layout of f_rest) and, forward, with /
# without the inverse ray-space covariance, counted where the wrappers launch
# (the tracer's group "launches.preprocess")
LAUNCHES = trace.counters("launches.preprocess",
                          tuple(f"preprocess_fwd[sh={d},inv={i}]"
                                for d in range(MAX_SH_DEGREE + 1) for i in (0, 1))
                          + tuple(f"preprocess_bwd[sh={d}]" for d in range(MAX_SH_DEGREE + 1)))


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def needs_grad(state) -> bool:
    """Whether a gradient can flow from the state's parameters: autograd is
    on and some tensor of ``state.params`` requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for _, t in state.params.items())


def preprocess_torch(state, camera, kernel_size: float = 0.0, scaling_modifier: float = 1.0,
                     compute_invraycov: bool = False) -> PreprocessOut:
    """The plain version: fused filtered scales and opacity, inactive slots
    culled; ``compute_invraycov`` adds the inverse ray-space covariance that
    integration needs."""
    scales, opacity = state.get_fused_scaling_opacity()
    opacity = torch.where(state.active[:, None], opacity, 0.0)
    prep = preprocess_gaussians(
        state.params.xyz,
        scales,
        state.get_rotation(),
        opacity,
        state.get_features(),
        sh_degree=state.max_sh_degree,
        camera=camera,
        kernel_size=kernel_size,
        scale_modifier=scaling_modifier,
        active_sh_degree=state.active_sh_degree,
        compute_invraycov=compute_invraycov,
    )
    return prep.replace(valid=prep.valid & state.active)


def from_table(table, radius, valid, well_conditioned, invraycov=None) -> PreprocessOut:
    """A ``PreprocessOut`` whose float fields are views of ``table`` (P, 24)."""
    c = COLUMNS
    return PreprocessOut(
        valid=valid,
        xy=table[:, c["xy"]],
        depth=table[:, DEPTH],
        view_point=table[:, c["view_point"]],
        conic=table[:, c["conic"]],
        opacity=table[:, c["opacity"]],
        rgb=table[:, c["rgb"]],
        camera_plane=table[:, c["camera_plane"]].unflatten(1, (2, 3)).transpose(1, 2),
        ray_plane=table[:, c["ray_plane"]],
        normal=table[:, c["normal"]],
        ts=table[:, c["ts"]],
        radius=radius,
        well_conditioned=well_conditioned,
        invraycov=invraycov,
    )


def _entry():
    return build.entry("preprocess_fwd", 17, 8, 2)


def preprocess_forward(state, camera, kernel_size: float = 0.0,
                       scaling_modifier: float = 1.0,
                       compute_invraycov: bool = False) -> PreprocessOut:
    """``preprocess_torch``'s result, from one launch of the kernel over the
    state's rows (CUDA tensors only; it raises otherwise, and on a failed
    launch). No gradient flows to the state."""
    p = state.params
    dev = p.xyz.device
    if dev.type != "cuda":
        raise ValueError(f"the preprocess kernel runs on cuda tensors, not {dev}")
    D = state.max_sh_degree
    if not 0 <= D <= MAX_SH_DEGREE:
        raise ValueError(f"the preprocess kernel takes SH degrees 0-{MAX_SH_DEGREE}, not {D}")
    P = state.capacity
    f32 = torch.float32
    rows = [("xyz", p.xyz, f32, (P, 3)), ("f_dc", p.f_dc, f32, (P, 1, 3)),
            ("f_rest", p.f_rest, f32, (P, (D + 1) ** 2 - 1, 3)),
            ("scaling", p.scaling, f32, (P, 3)), ("rotation", p.rotation, f32, (P, 4)),
            ("opacity", p.opacity, f32, (P, 1)), ("filter_3d", state.filter_3d, f32, (P, 1)),
            ("active", state.active, torch.bool, (P,)), ("camera.fovx", camera.fovx, f32, ()),
            ("camera.fovy", camera.fovy, f32, ())]
    for name, x, dtype, shape in rows:
        build.check_tensor(name, x, dtype, shape, dev)
    for name in ("f_rest", "rotation"):  # read as 16-byte words
        if getattr(p, name).data_ptr() % 16:
            raise ValueError(f"preprocess kernel: {name} must be 16-byte aligned")
    # the camera's R and T are read at their strides (Camera.look_at's R is a
    # transpose)
    for name, x, shape in (("camera.R", camera.R, (3, 3)), ("camera.T", camera.T, (3,))):
        if x.device != dev or x.dtype != f32 or tuple(x.shape) != shape:
            raise ValueError(f"kernel input {name} must be a {f32} tensor of shape {shape} on "
                             f"{dev}; got {x.dtype} {tuple(x.shape)} on {x.device}")
    table = torch.empty((P, N_FEAT), dtype=f32, device=dev)
    radius = torch.empty((P,), dtype=f32, device=dev)
    valid = torch.empty((P,), dtype=torch.bool, device=dev)
    well = torch.empty((P,), dtype=torch.bool, device=dev)
    invraycov = torch.empty((P, 3, 3), dtype=f32, device=dev) if compute_invraycov else None
    with on_device(dev):
        rc = _entry()(*(x.data_ptr() for _, x, _, _ in rows[:8]), camera.R.data_ptr(),
                      camera.T.data_ptr(), camera.fovx.data_ptr(), camera.fovy.data_ptr(),
                      table.data_ptr(), radius.data_ptr(), valid.data_ptr(), well.data_ptr(),
                      None if invraycov is None else invraycov.data_ptr(), *camera.R.stride(),
                      camera.T.stride(0), P, camera.width,
                      camera.height, D, state.active_sh_degree, float(kernel_size),
                      float(scaling_modifier), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"preprocess_fwd kernel launch failed with CUDA error {rc}")
    trace.count("launches.preprocess", f"preprocess_fwd[sh={D},inv={int(compute_invraycov)}]")
    return from_table(table, radius, valid, well, invraycov)


def _bwd_entry():
    return build.entry("preprocess_bwd", 20, 8, 2)


def _cotangents(grads: dict, P: int, dev):
    """The incoming gradients as the C entry's two host arrays: their
    pointers (null for a field with none) and three strides each (in
    floats)."""
    ptrs = (ctypes.c_void_p * len(GRAD_FIELDS))()
    strides = (ctypes.c_longlong * (3 * len(GRAD_FIELDS)))()
    for k, (name, ndim) in enumerate(GRAD_FIELDS):
        g = grads.get(name)
        if g is None:
            continue
        if g.device != dev or g.dtype != torch.float32 or g.dim() != ndim or g.shape[0] != P:
            raise ValueError(f"the gradient of {name} must be a {ndim}-d float32 tensor of {P} "
                             f"rows on {dev}; got {g.dtype} {tuple(g.shape)} on {g.device}")
        ptrs[k] = g.data_ptr()
        strides[3 * k:3 * k + ndim] = g.stride()
    return ptrs, strides


def launch_backward(entry, state, camera, kernel_size: float, scaling_modifier: float,
                    grads: dict, stream=None) -> GaussianParams:
    """One call of the backward's C entry ``entry`` (the kernel's, or a host
    build of the same source): the gradients of the state's six parameter
    tensors from ``grads`` ({field: incoming gradient or None}) at the view
    of ``camera``. The checks of ``preprocess_forward`` on the inputs; the
    caller checks the device."""
    p = state.params
    dev = p.xyz.device
    D = state.max_sh_degree
    if not 0 <= D <= MAX_SH_DEGREE:
        raise ValueError(f"the preprocess kernel takes SH degrees 0-{MAX_SH_DEGREE}, not {D}")
    P = state.capacity
    f32 = torch.float32
    rows = [("xyz", p.xyz, f32, (P, 3)), ("f_dc", p.f_dc, f32, (P, 1, 3)),
            ("f_rest", p.f_rest, f32, (P, (D + 1) ** 2 - 1, 3)),
            ("scaling", p.scaling, f32, (P, 3)), ("rotation", p.rotation, f32, (P, 4)),
            ("opacity", p.opacity, f32, (P, 1)), ("filter_3d", state.filter_3d, f32, (P, 1)),
            ("active", state.active, torch.bool, (P,)), ("camera.fovx", camera.fovx, f32, ()),
            ("camera.fovy", camera.fovy, f32, ())]
    for name, x, dtype, shape in rows:
        build.check_tensor(name, x, dtype, shape, dev)
    for name in ("f_rest", "rotation"):  # read as 16-byte words
        if getattr(p, name).data_ptr() % 16:
            raise ValueError(f"preprocess kernel: {name} must be 16-byte aligned")
    for name, x, shape in (("camera.R", camera.R, (3, 3)), ("camera.T", camera.T, (3,))):
        if x.device != dev or x.dtype != f32 or tuple(x.shape) != shape:
            raise ValueError(f"kernel input {name} must be a {f32} tensor of shape {shape} on "
                             f"{dev}; got {x.dtype} {tuple(x.shape)} on {x.device}")
    ptrs, strides = _cotangents(grads, P, dev)
    out = p.map(torch.empty_like)
    rc = entry(*(x.data_ptr() for _, x, _, _ in rows[:8]), camera.R.data_ptr(),
               camera.T.data_ptr(), camera.fovx.data_ptr(), camera.fovy.data_ptr(),
               ctypes.addressof(ptrs), ctypes.addressof(strides),
               *(t.data_ptr() for _, t in out.items()), *camera.R.stride(), camera.T.stride(0),
               P, camera.width, camera.height, D, state.active_sh_degree, float(kernel_size),
               float(scaling_modifier), stream)
    if rc != 0:
        raise RuntimeError(f"preprocess_bwd kernel launch failed with CUDA error {rc}")
    return out


def preprocess_backward(state, camera, kernel_size: float, scaling_modifier: float,
                        grads: dict) -> GaussianParams:
    """The gradients of the state's six parameter tensors, from one launch of
    the backward kernel over the state's rows (CUDA tensors only; it raises
    otherwise, and on a failed launch): ``grads`` maps each field of
    ``GRAD_FIELDS`` to its incoming gradient, any strides, or None."""
    dev = state.params.xyz.device
    if dev.type != "cuda":
        raise ValueError(f"the preprocess kernel runs on cuda tensors, not {dev}")
    with on_device(dev):
        out = launch_backward(_bwd_entry(), state, camera, kernel_size, scaling_modifier, grads,
                              torch.cuda.current_stream().cuda_stream)
    trace.count("launches.preprocess", f"preprocess_bwd[sh={state.max_sh_degree}]")
    return out


class PreprocessFunction(torch.autograd.Function):
    """The kernel pair between the state's six parameter tensors and the
    fields of ``PreprocessOut``: forward ``preprocess_forward`` (its
    differentiable fields are views of the kernel's table), backward
    ``preprocess_backward``, which recomputes what it needs from the
    parameters; autograd hands it each field's gradient as it is, None for
    a field with none."""

    @staticmethod
    def forward(ctx, state, camera, kernel_size, scaling_modifier, *params):
        out = preprocess_forward(state, camera, kernel_size, scaling_modifier)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*params)
        ctx.view = (state, camera, kernel_size, scaling_modifier)
        ctx.mark_non_differentiable(out.radius, out.valid, out.well_conditioned)
        return tuple(getattr(out, f) for f, _ in GRAD_FIELDS) + (
            out.radius, out.valid, out.well_conditioned)

    @staticmethod
    def backward(ctx, *grads):
        state, camera, kernel_size, scaling_modifier = ctx.view
        state = state.replace(params=GaussianParams(*ctx.saved_tensors))
        out = preprocess_backward(state, camera, kernel_size, scaling_modifier,
                                  {f: g for (f, _), g in zip(GRAD_FIELDS, grads)})
        return (None, None, None, None, *(t for _, t in out.items()))


def preprocess_train(state, camera, kernel_size: float = 0.0, scaling_modifier: float = 1.0,
                     compute_invraycov: bool = False) -> PreprocessOut:
    """``preprocess_torch``'s result, and its gradient to the state's
    parameters, from the kernel pair (``PreprocessFunction``; CUDA tensors
    only). The backward has no inverse ray-space covariance: asked for one,
    it raises."""
    if compute_invraycov:
        raise ValueError("the preprocess backward kernel has no inverse ray-space covariance")
    outs = PreprocessFunction.apply(state, camera, float(kernel_size), float(scaling_modifier),
                                    *(t for _, t in state.params.items()))
    f = dict(zip([n for n, _ in GRAD_FIELDS] + ["radius", "valid", "well_conditioned"], outs))
    return PreprocessOut(**f)
