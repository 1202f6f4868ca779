"""The preprocess of a view, from the state's raw tensors to the rasterizer's
per-Gaussian inputs: the CUDA kernel ``csrc/preprocess_fwd.cu`` behind
``preprocess_forward``, its gradient ``csrc/preprocess_bwd.cu`` behind
``preprocess_backward``, the two joined as a ``torch.autograd.Function`` in
``preprocess_train`` for views on a card that a gradient flows from, and
their plain PyTorch version ``preprocess_torch`` (the state's getters —
fused filtered scales and opacity, normalised rotation, the SH features —
and ``core/projection.preprocess_gaussians``), which autograd
differentiates on the CPU.

The kernel writes the per-Gaussian table (``core/projection.py``: its
column order and its contract, opacity 0 where a row is not valid) beside
``radius``, ``valid``, ``well_conditioned`` and, asked, ``invraycov``; the
``PreprocessOut`` it returns holds that table. Its inactive rows are zeros,
where the plain version's are not; nothing reads them.

The backward kernel takes the incoming gradient of the table where autograd
hands it over (one pointer and a row stride; none reads as zero) and writes
the gradients of the six parameter tensors in their own layouts: the
gradient autograd takes through the plain version on every active row,
zeros on an inactive one.
"""

from __future__ import annotations

import torch

from radegs_torch.core.projection import N_FEAT, PreprocessOut, preprocess_gaussians
from radegs_torch.models.gaussian_model import GaussianParams
from radegs_torch.native import build
from radegs_torch.utils import trace
from radegs_torch.utils.device import on_device

MAX_SH_DEGREE = 3

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


def _kernel_args(state, camera):
    """The checks both kernels' C entries need of the state and the camera
    (CUDA tensors, or the CPU's for a host build). Returns their pointers in
    the entries' order (the state's eight tensors, R, T, fovx, fovy) and
    the camera's strides (R's two, T's one; ``Camera.look_at``'s R is a
    transpose)."""
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
            ("active", state.active, torch.bool, (P,))]
    for name, x, dtype, shape in rows + [("camera.fovx", camera.fovx, f32, ()),
                                         ("camera.fovy", camera.fovy, f32, ())]:
        build.check_tensor(name, x, dtype, shape, dev)
    for name in ("f_rest", "rotation"):  # read as 16-byte words
        if getattr(p, name).data_ptr() % 16:
            raise ValueError(f"preprocess kernel: {name} must be 16-byte aligned")
    for name, x, shape in (("camera.R", camera.R, (3, 3)), ("camera.T", camera.T, (3,))):
        if x.device != dev or x.dtype != f32 or tuple(x.shape) != shape:
            raise ValueError(f"kernel input {name} must be a {f32} tensor of shape {shape} on "
                             f"{dev}; got {x.dtype} {tuple(x.shape)} on {x.device}")
    ptrs = [x.data_ptr() for _, x, _, _ in rows] + [
        x.data_ptr() for x in (camera.R, camera.T, camera.fovx, camera.fovy)]
    return ptrs, (*camera.R.stride(), camera.T.stride(0))


def _entry():
    return build.entry("preprocess_fwd", 17, 8, 2)


def preprocess_forward(state, camera, kernel_size: float = 0.0,
                       scaling_modifier: float = 1.0,
                       compute_invraycov: bool = False) -> PreprocessOut:
    """``preprocess_torch``'s result, from one launch of the kernel over the
    state's rows (CUDA tensors only; it raises otherwise, and on a failed
    launch). No gradient flows to the state."""
    dev = state.params.xyz.device
    if dev.type != "cuda":
        raise ValueError(f"the preprocess kernel runs on cuda tensors, not {dev}")
    ptrs, strides = _kernel_args(state, camera)
    P, D, f32 = state.capacity, state.max_sh_degree, torch.float32
    table = torch.empty((P, N_FEAT), dtype=f32, device=dev)
    radius = torch.empty((P,), dtype=f32, device=dev)
    valid = torch.empty((P,), dtype=torch.bool, device=dev)
    well = torch.empty((P,), dtype=torch.bool, device=dev)
    invraycov = torch.empty((P, 3, 3), dtype=f32, device=dev) if compute_invraycov else None
    with on_device(dev):
        rc = _entry()(*ptrs, table.data_ptr(), radius.data_ptr(), valid.data_ptr(),
                      well.data_ptr(), None if invraycov is None else invraycov.data_ptr(),
                      *strides, P, camera.width, camera.height, D, state.active_sh_degree,
                      float(kernel_size), float(scaling_modifier),
                      torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"preprocess_fwd kernel launch failed with CUDA error {rc}")
    trace.count("launches.preprocess", f"preprocess_fwd[sh={D},inv={int(compute_invraycov)}]")
    return PreprocessOut(table, valid, radius, well, invraycov)


def _bwd_entry():
    return build.entry("preprocess_bwd", 19, 9, 2)


def launch_backward(entry, state, camera, kernel_size: float, scaling_modifier: float,
                    grad, stream=None) -> GaussianParams:
    """One call of the backward's C entry ``entry`` (the kernel's, or a host
    build of the same source): the gradients of the state's six parameter
    tensors from ``grad``, the table's incoming gradient ((P, N_FEAT)
    float32, any row stride; None reads as zero), at the view of
    ``camera``. The checks of ``preprocess_forward`` on the inputs; the
    caller checks the device."""
    ptrs, strides = _kernel_args(state, camera)
    dev, P = state.params.xyz.device, state.capacity
    if grad is not None:
        if grad.device != dev or grad.dtype != torch.float32 or tuple(grad.shape) != (P, N_FEAT):
            raise ValueError(f"the table's gradient must be a float32 tensor of shape "
                             f"{(P, N_FEAT)} on {dev}; got {grad.dtype} {tuple(grad.shape)} "
                             f"on {grad.device}")
        if grad.stride(1) != 1:  # the kernel reads a row's columns together
            grad = grad.contiguous()
    out = state.params.map(torch.empty_like)
    rc = entry(*ptrs, None if grad is None else grad.data_ptr(),
               *(t.data_ptr() for _, t in out.items()), 0 if grad is None else grad.stride(0),
               *strides, P, camera.width, camera.height, state.max_sh_degree,
               state.active_sh_degree, float(kernel_size), float(scaling_modifier), stream)
    if rc != 0:
        raise RuntimeError(f"preprocess_bwd kernel launch failed with CUDA error {rc}")
    return out


def preprocess_backward(state, camera, kernel_size: float, scaling_modifier: float,
                        grad) -> GaussianParams:
    """The gradients of the state's six parameter tensors, from one launch of
    the backward kernel over the state's rows (CUDA tensors only; it raises
    otherwise, and on a failed launch): ``grad`` is the table's incoming
    gradient, at any row stride, or None."""
    dev = state.params.xyz.device
    if dev.type != "cuda":
        raise ValueError(f"the preprocess kernel runs on cuda tensors, not {dev}")
    with on_device(dev):
        out = launch_backward(_bwd_entry(), state, camera, kernel_size, scaling_modifier, grad,
                              torch.cuda.current_stream().cuda_stream)
    trace.count("launches.preprocess", f"preprocess_bwd[sh={state.max_sh_degree}]")
    return out


class PreprocessFunction(torch.autograd.Function):
    """The kernel pair between the state's six parameter tensors and the
    per-Gaussian table: forward ``preprocess_forward``, backward
    ``preprocess_backward``, which recomputes what it needs from the
    parameters; autograd hands it the table's gradient as it is."""

    @staticmethod
    def forward(ctx, state, camera, kernel_size, scaling_modifier, *params):
        out = preprocess_forward(state, camera, kernel_size, scaling_modifier)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*params)
        ctx.view = (state, camera, kernel_size, scaling_modifier)
        ctx.mark_non_differentiable(out.radius, out.valid, out.well_conditioned)
        return out.table, out.radius, out.valid, out.well_conditioned

    @staticmethod
    def backward(ctx, g_table, *_):
        state, camera, kernel_size, scaling_modifier = ctx.view
        state = state.replace(params=GaussianParams(*ctx.saved_tensors))
        out = preprocess_backward(state, camera, kernel_size, scaling_modifier, g_table)
        return (None, None, None, None, *(t for _, t in out.items()))


def preprocess_train(state, camera, kernel_size: float = 0.0, scaling_modifier: float = 1.0,
                     compute_invraycov: bool = False) -> PreprocessOut:
    """``preprocess_torch``'s result, and its gradient to the state's
    parameters, from the kernel pair (``PreprocessFunction``; CUDA tensors
    only). The backward has no inverse ray-space covariance: asked for one,
    it raises."""
    if compute_invraycov:
        raise ValueError("the preprocess backward kernel has no inverse ray-space covariance")
    table, radius, valid, well = PreprocessFunction.apply(
        state, camera, float(kernel_size), float(scaling_modifier),
        *(t for _, t in state.params.items()))
    return PreprocessOut(table, valid, radius, well)
