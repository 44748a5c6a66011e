"""The single-device SVR pipeline.

Port of fetalreconstruction_tpu/pipeline/svr.py:44-930 for mesh=None (the
reference's reconstruction.cc:70-1301):

  mask prep -> template crop -> CreateTemplate -> SetMask ->
  StackRegistrations -> per-stack mask crop -> StackRegistrations ->
  MatchStackIntensitiesWithMasking -> CreateSlicesAndTransformations ->
  MaskSlices -> outer loop {package / slice-to-volume registration,
  smoothing schedule, GaussianReconstruction, SimulateSlices,
  InitializeRobustStatistics, EStep, inner SR loop} ->
  RestoreSliceIntensities -> ScaleVolume [-> --manualMask, --bspline].

Host steps stay numpy as in the JAX version; device work runs on the
explicit `device`.  The per-phase PerfStats table always holds device
time: on a CUDA device every sample is taken after a synchronise (a
handful per outer iteration).  Both PSF engines (cfg.engine "fast" or
"exact"), bias correction, PVR's slice factories, the patch / superpixel
slice modes, --manualMask and --bspline run as in the JAX version.  A
mesh is not ported yet and is refused with NotImplementedError naming its
ROADMAP.md queue 1 item (13).
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch

from ..core.geometry import ImageAttributes, invert_rigid
from ..core.image import Image, split_4d
from ..em.robust import scale_volume_factor
from ..io.dof import read_dof, read_transformations
from ..io.nifti import read_nifti, read_stacks, write_nifti
from ..ops import psf as psf_ops
from ..ops.gaussian import gaussian_blur
from ..ops.manual_mask import transform_manual_mask
from ..ops.psf_fast import FastPSF
from ..ops.sampling import resample_to_grid
from ..patches.extract import extract_patches
from ..patches.slic import extract_superpixel_patches
from ..register import slice2vol as s2v
from ..register.package import package_to_volume, split_image
from ..register.prepare import prepare_registration_slices
from ..register.stack import stack_registrations
from ..sr.bspline import bspline_reconstruct
from ..sr.superresolution import mask_volume, smoothing_parameters
from ..utils.motion import select_template
from ..utils.perfstats import PerfStats
from . import svr_core
from .checkpoint import load_checkpoint, save_checkpoint
from .config import SVRConfig
from .state import SliceBatch, create_slices


# ---------------------------------------------------------------------------
# host-side preparation steps
# ---------------------------------------------------------------------------

def create_mask_from_overlap(stacks: List[Image]) -> Image:
    """Voxels of stack[0]'s grid inside EVERY stack's field of view
    (CreateMaskFromOverlap, irtkReconstructionGPU.cc:696)."""
    base = stacks[0]
    zs, ys, xs = base.attr.shape_zyx
    z, y, x = np.meshgrid(np.arange(zs), np.arange(ys), np.arange(xs),
                          indexing="ij")
    pts = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float64)
    w = base.attr.image_to_world(pts)
    inside = np.ones(len(w), bool)
    for st in stacks:
        p = st.attr.world_to_image(w)
        inside &= ((p[:, 0] >= 0) & (p[:, 0] < st.attr.x)
                   & (p[:, 1] >= 0) & (p[:, 1] < st.attr.y)
                   & (p[:, 2] >= 0) & (p[:, 2] < st.attr.z))
    return Image(inside.reshape(zs, ys, xs).astype(np.float32),
                 base.attr.copy())


def transform_mask(image: Image, mask: Image, transform: np.ndarray, *,
                   device) -> Image:
    """NN-resample the mask onto `image`'s grid through `transform` (stack
    world -> mask world), 0 outside (TransformMask, .cc:805).  The float64
    product mask.w2i @ transform is cast to float32 before it meets the
    grid, as in JAX."""
    out = resample_to_grid(
        torch.as_tensor(mask.data, device=device),
        (mask.attr.w2i() @ transform).astype(np.float32),
        image.attr.shape_zyx, image.attr.i2w().astype(np.float32),
        interp="nn", padding=0.0)
    return Image(out.cpu().numpy(), image.attr.copy())


def crop_image(image: Image, mask: Image) -> Image:
    """Crop to the inclusive bounding box of mask > 0 (CropImage,
    .cc:5205)."""
    nz = np.nonzero(mask.data > 0)
    if len(nz[0]) == 0:
        raise ValueError("empty mask - cannot crop")
    z1, z2 = int(nz[0].min()), int(nz[0].max())
    y1, y2 = int(nz[1].min()), int(nz[1].max())
    x1, x2 = int(nz[2].min()), int(nz[2].max())
    return image.get_region(x1, y1, z1, x2 + 1, y2 + 1, z2 + 1)


def create_template(stack: Image, resolution: float) -> ImageAttributes:
    """Reconstruction grid = template stack enlarged by 2 slices in z and
    resampled to isotropic `resolution` (CreateTemplate, .cc:648)."""
    a = stack.attr.copy()
    a.z += 2
    if resolution <= 0:
        resolution = min(a.dx, a.dy, a.dz)
    return a.with_spacing(resolution, resolution, resolution)


def set_mask(mask: Optional[Image], recon_attr: ImageAttributes,
             sigma: float, threshold: float = 0.5, *, device) -> Image:
    """Smooth + binarise the mask and NN-resample it onto the recon grid
    (SetMask, .cc:750)."""
    if mask is None:
        return Image(np.ones(recon_attr.shape_zyx, np.float32),
                     recon_attr.copy())
    data = torch.as_tensor(mask.data, device=device)
    if sigma > 0:
        data = (gaussian_blur(data, sigma, mask.attr.spacing)
                > threshold).to(torch.float32)
    out = resample_to_grid(data, mask.attr.w2i().astype(np.float32),
                           recon_attr.shape_zyx,
                           recon_attr.i2w().astype(np.float32),
                           interp="nn", padding=0.0)
    return Image(out.cpu().numpy(), recon_attr.copy())


def _mask_values(mask: Image, world: np.ndarray):
    """(in bounds, mask value) at the voxels that world points round to."""
    p = np.round(mask.attr.world_to_image(world)).astype(int)
    inb = ((p[:, 0] >= 0) & (p[:, 0] < mask.attr.x)
           & (p[:, 1] >= 0) & (p[:, 1] < mask.attr.y)
           & (p[:, 2] >= 0) & (p[:, 2] < mask.attr.z))
    pc = np.clip(p, 0, [mask.attr.x - 1, mask.attr.y - 1, mask.attr.z - 1])
    return inb, mask.data[pc[:, 2], pc[:, 1], pc[:, 0]]


def match_stack_intensities(stacks: List[Image], stack_transforms,
                            mask: Image, average_value: float,
                            together: bool = False):
    """Per-stack factor = average_value / mean of the stack's values at
    voxels whose transformed position rounds into mask == 1
    (MatchStackIntensitiesWithMasking, .cc:1375).  Rescales the stacks in
    place (values > 0 only) and returns the factors."""
    averages = []
    for st, t in zip(stacks, stack_transforms):
        zs, ys, xs = st.attr.shape_zyx
        z, y, x = np.meshgrid(np.arange(zs), np.arange(ys), np.arange(xs),
                              indexing="ij")
        pts = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float64)
        w = st.attr.image_to_world(pts)
        w = w @ np.asarray(t)[:3, :3].T + np.asarray(t)[:3, 3]
        inb, mval = _mask_values(mask, w)
        vals = st.data.reshape(-1)[inb & (mval == 1)]
        if len(vals) == 0:
            raise ValueError("stack has no overlap with ROI")
        averages.append(float(vals.mean()))
    if together:
        factors = [average_value / float(np.mean(averages))] * len(stacks)
    else:
        factors = [average_value / a for a in averages]
    for st, f in zip(stacks, factors):
        st.data[st.data > 0] *= f
    return np.asarray(factors, np.float32)


def mask_slices(batch: SliceBatch, transforms: np.ndarray,
                mask: Image) -> None:
    """Outside-mask or near-zero slice pixels -> -1 (MaskSlices,
    .cc:1940).  Mutates batch.data."""
    for i in range(batch.data.shape[0]):
        a = batch.attrs[i]
        ys, xs = np.meshgrid(np.arange(a.y), np.arange(a.x), indexing="ij")
        pts = np.stack([xs, ys, np.zeros_like(xs)], -1).reshape(-1, 3)
        wpt = a.image_to_world(pts.astype(np.float64))
        t = transforms[i]
        wpt = wpt @ t[:3, :3].T + t[:3, 3]
        inb, mval = _mask_values(mask, wpt)
        sl = batch.data[i, :a.y, :a.x].reshape(-1)
        sl[sl < 0.01] = -1.0
        sl[~(inb & (mval != 0))] = -1.0
        batch.data[i, :a.y, :a.x] = sl.reshape(a.y, a.x)


def replace_slices(folder: str, batch: SliceBatch) -> SliceBatch:
    """--sfolder (replaceSlices, irtkReconstructionGPU.cc:4767): replace
    slice data with slices read from a folder (sorted order); geometry is
    kept."""
    files = sorted(os.path.join(folder, f) for f in os.listdir(folder)
                   if f.endswith((".nii", ".nii.gz")))
    for i, f in enumerate(files[:batch.n_slices]):
        img = read_nifti(f)
        d = img.data[0] if img.data.ndim == 3 else img.data
        h = min(d.shape[0], batch.data.shape[1])
        w = min(d.shape[1], batch.data.shape[2])
        batch.data[i, :, :] = -1.0
        batch.data[i, :h, :w] = d[:h, :w]
    return batch


# ---------------------------------------------------------------------------
# the full pipeline
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SVRResult:
    """The same fields as the JAX package's SVRResult."""
    reconstructed: Image
    transforms: np.ndarray          # (N, 4, 4) final slice transforms
    slice_weights: np.ndarray       # (N,)
    stack_factors: np.ndarray
    stats: PerfStats
    excluded_slices: List[int]
    slice_inside: Optional[np.ndarray] = None   # (N,) bool
    manual_mask_volume: Optional[Image] = None  # --manualMask output
    bspline_reconstructed: Optional[Image] = None  # --bspline output

    def inclusion_report(self) -> str:
        """Included / excluded / outside slice lists (Evaluate,
        irtkReconstructionGPU.cc:4540)."""
        sw = self.slice_weights
        inside = (self.slice_inside if self.slice_inside is not None
                  else np.ones_like(sw, bool))
        return _inclusion_lists(sw, inside)


def _inclusion_lists(sw, inside) -> str:
    inc = np.nonzero((sw >= 0.5) & inside)[0]
    exc = np.nonzero((sw < 0.5) & inside)[0]
    out = np.nonzero(~inside)[0]
    return ("Included slices: %s\nTotal: %d\n"
            "Excluded slices: %s\nTotal: %d\n"
            "Outside slices: %s\nTotal: %d"
            % (" ".join(map(str, inc)), len(inc),
               " ".join(map(str, exc)), len(exc),
               " ".join(map(str, out)), len(out)))


def _load_stacks(cfg: SVRConfig, stacks):
    """Stacks as float32 copies, 4D inputs split into 3D volumes (per-stack
    thickness / package entries duplicated, reconstruction.cc:279-303),
    then --num_stacks_tuner.  Returns (stacks, thickness, packages)."""
    if stacks is None:
        stacks = [Image(s.data.astype(np.float32), s.attr)
                  for s in read_stacks(cfg.input_stacks)]
    else:
        stacks = [Image(np.array(s.data, np.float32, copy=True),
                        s.attr.copy()) for s in stacks]
    thickness, packages = list(cfg.thickness), list(cfg.packages)
    if any(s.data.ndim == 4 for s in stacks):
        split, thick, pkgs = [], [], []
        for i, s in enumerate(stacks):
            parts = split_4d(s.data, s.attr) if s.data.ndim == 4 else [s]
            split.extend(parts)
            if thickness:
                thick.extend([thickness[i]] * len(parts))
            if packages:
                pkgs.extend([packages[i]] * len(parts))
        stacks, thickness, packages = split, thick, pkgs
    if cfg.num_stacks_tuner > 0:
        k = cfg.num_stacks_tuner
        stacks, thickness, packages = stacks[:k], thickness[:k], packages[:k]
    return stacks, thickness, packages


def run_svr(cfg: SVRConfig, stacks: Optional[List[Image]] = None,
            mask: Optional[Image] = None,
            reference_volume: Optional[Image] = None, *, device,
            slice_factory=None, mesh=None,
            iteration_hook=None) -> SVRResult:
    """Reconstruct a volume from thick-slice stacks on `device`.

    stacks / mask: Images (default: read cfg.input_stacks / cfg.mask).
    reference_volume (or cfg.reference_volume): seeds the reconstruction,
    and registration then runs already at iteration 0 (reconstruction.cc:
    254-258, 826).  iteration_hook(it, recon Image, transforms) is called
    after each outer iteration.  slice_factory (optional):
    callable(cropped stacks, thickness, recon mask Image, stack transforms)
    -> SliceBatch, which PVR uses to put patches in place of whole slices;
    cfg.patch_based / cfg.superpixel_based build one here.  A mesh is
    refused (not ported yet).
    """
    if mesh is not None:
        raise NotImplementedError("multi-device (mesh) is not ported yet: "
                                  "ROADMAP.md queue 1 item 13")
    device = torch.device(device)
    f32 = torch.float32
    stats = PerfStats(device)
    sample = stats.sample

    # ----- load inputs ----------------------------------------------------
    stacks, cfg_thickness, cfg_packages = _load_stacks(cfg, stacks)
    if mask is None and cfg.mask is not None:
        mask = read_nifti(cfg.mask)
    n_stacks = len(stacks)
    thickness = cfg_thickness or [2.0 * s.attr.dz for s in stacks]
    tmpl = cfg.template_number
    if cfg.use_auto_template:
        tmpl = select_template(stacks)
    stack_transforms = np.tile(np.eye(4), (n_stacks, 1, 1))
    if cfg.transformation_files:
        # .dof files store template -> stack; the stored convention is the
        # inverse (reconstruction.cc:399)
        for i, f in enumerate(cfg.transformation_files[:n_stacks]):
            if f and f != "id":
                stack_transforms[i] = invert_rigid(read_dof(f))
    if reference_volume is None and cfg.reference_volume:
        reference_volume = read_nifti(cfg.reference_volume)

    # --T1PackageSize: split every stack into packages registered to the
    # external reference volume (reconstruction.cc:494-556)
    external_target = None
    if cfg.t1_package_size > 0:
        if reference_volume is None:
            raise ValueError("--T1PackageSize requires a reference volume")
        external_target = reference_volume
        stacks = [p for st in stacks
                  for p in split_image(st, cfg.t1_package_size)]
        n_stacks = len(stacks)
        thickness = [2.0 * s.attr.dz for s in stacks]
        stack_transforms = np.tile(np.eye(4), (n_stacks, 1, 1))
    sample("load")

    # --manualMask: a per-slice segmentation of the FIRST stack, pushed
    # through the PSF at the end (reconstruction.cc:261-264, 1240-1249);
    # it is cropped with that stack
    manual_img = read_nifti(cfg.manual_mask) if cfg.manual_mask else None

    # ----- mask prep + template grid --------------------------------------
    if mask is None:
        mask = create_mask_from_overlap(stacks)
    m_tmpl = transform_mask(stacks[tmpl], mask, stack_transforms[tmpl],
                            device=device)
    stacks[tmpl] = crop_image(stacks[tmpl], m_tmpl)
    if manual_img is not None and tmpl == 0:
        manual_img = crop_image(manual_img, m_tmpl)
    recon_attr = create_template(stacks[tmpl], cfg.resolution)
    recon_mask_img = set_mask(mask, recon_attr, cfg.smooth_mask,
                              device=device)
    sample("template+mask")

    # ----- stack registrations x2, crop, intensity matching ---------------
    # the target is the template stack (or the external volume) with the
    # recon-grid mask resampled onto it and voxels outside zeroed
    def template_mask():
        if external_target is not None:
            return transform_mask(external_target, recon_mask_img,
                                  np.eye(4), device=device)
        return transform_mask(stacks[tmpl], recon_mask_img,
                              stack_transforms[tmpl], device=device)

    use_nmi = cfg.use_nmi or external_target is not None
    stack_transforms = stack_registrations(
        stacks, tmpl, mask=template_mask(),
        external_template=external_target, use_nmi=use_nmi, device=device)
    for i in range(n_stacks):
        if i != tmpl:
            mi = transform_mask(stacks[i], recon_mask_img,
                                stack_transforms[i], device=device)
            stacks[i] = crop_image(stacks[i], mi)
            if manual_img is not None and i == 0:
                manual_img = crop_image(manual_img, mi)
    stack_transforms = stack_registrations(
        stacks, tmpl, mask=template_mask(), init_transforms=stack_transforms,
        external_template=external_target, use_nmi=use_nmi, device=device)
    sample("stack registration")
    if cfg.debug:
        for i, st in enumerate(stacks):
            write_nifti(st, f"{cfg.log_prefix}stack{i}.nii.gz")

    stack_factors = match_stack_intensities(
        stacks, stack_transforms, recon_mask_img, cfg.average_value,
        together=not cfg.intensity_matching)
    sample("intensity matching")

    # ----- slices / patches -------------------------------------------------
    # the SVR tool's experimental patch / superpixel slice modes
    # (reconstruction.cc:733-747)
    if slice_factory is None and cfg.patch_based:
        def slice_factory(st, th, m, tr):
            return extract_patches(st, th, cfg.patch_size, cfg.patch_stride,
                                   mask=m, stack_transforms=tr)
    elif slice_factory is None and cfg.superpixel_based:
        def slice_factory(st, th, m, tr):
            # SLIC with compactness 1 and an explicit label count
            # (reconstruction.cc:311-316)
            return extract_superpixel_patches(
                st, th, compactness=1.0,
                num_superpixels=int(cfg.num_superpixels) or None)
    if slice_factory is not None:
        batch = slice_factory(stacks, thickness, recon_mask_img,
                              stack_transforms)
    else:
        batch = create_slices(stacks, thickness)
    if cfg.sfolder:
        batch = replace_slices(cfg.sfolder, batch)
    n = batch.n_slices
    transforms = np.stack([stack_transforms[batch.stack_index[i]]
                           for i in range(n)]).astype(np.float64)
    if slice_factory is None:  # patch factories mask their own pixels
        mask_slices(batch, transforms, recon_mask_img)
    sample("create slices")

    # ----- device setup ---------------------------------------------------
    support = psf_ops.reference_support(batch.dims, recon_attr.dx,
                                        cfg.quality_factor,
                                        cfg.max_psf_support)
    ctx = svr_core.SVRContext(
        vol_shape=recon_attr.shape_zyx,
        vol_spacing=(recon_attr.dx, recon_attr.dy, recon_attr.dz),
        slice_spacing_xy=(stacks[0].attr.dx, stacks[0].attr.dy),
        sigma_bias=cfg.sigma,
        global_bias_correction=cfg.global_bias_correction,
        disable_bias=cfg.disable_bias_correction, delta=cfg.delta,
        low_intensity_cutoff=cfg.low_intensity_cutoff,
        fast=(FastPSF.from_batch(batch, recon_attr.w2i(), support)
              if cfg.engine == "fast" else None),
        offsets=psf_ops.make_offsets(support))
    slices = torch.as_tensor(batch.data, device=device)
    valid = torch.as_tensor(batch.data != -1.0, device=device)
    slice_i2w = torch.as_tensor(batch.i2w, dtype=f32, device=device)
    slice_dims = torch.as_tensor(batch.dims, dtype=f32, device=device)
    stack_id = torch.as_tensor(batch.stack_index, dtype=torch.int64,
                               device=device)
    recon_w2i = torch.as_tensor(recon_attr.w2i(), dtype=f32, device=device)
    mask_t = torch.as_tensor(recon_mask_img.data, device=device)
    mask_flat = mask_t.reshape(-1)
    pos = batch.data[batch.data > 0]
    max_i = float(pos.max()) if pos.size else 1.0
    min_i = float(pos.min()) if pos.size else 0.0
    force_excluded = np.zeros((n,), bool)
    for idx in cfg.force_excluded:
        if 0 <= idx < n:
            force_excluded[idx] = True
    if cfg.tfolder:
        transforms = read_transformations(cfg.tfolder, n)

    reg_targets = None
    reg_cfg = s2v.SliceRegConfig(levels=cfg.reg_levels,
                                 iterations=cfg.reg_iterations,
                                 metric="nmi" if cfg.use_nmi else "ncc",
                                 optimizer=cfg.reg_optimizer)
    do_bias = (cfg.intensity_matching and not cfg.disable_bias_correction
               and cfg.sigma > 0)
    do_nbias = do_bias and not cfg.global_bias_correction

    recon = torch.zeros(recon_attr.shape_zyx, dtype=f32, device=device)
    have_reference = reference_volume is not None
    if have_reference:
        recon = resample_to_grid(
            torch.as_tensor(reference_volume.data, dtype=f32, device=device),
            reference_volume.attr.w2i().astype(np.float32),
            recon_attr.shape_zyx, recon_attr.i2w().astype(np.float32),
            interp="linear", padding=0.0)
    em = svr_core.init_em_state(n, valid)
    small_slices = np.zeros((n,), bool)
    sample("device setup")

    # ----- checkpoint / resume: (iteration, volume, transforms) is the
    # whole resume state; EM state restarts every outer iteration
    start_it = 0
    if cfg.checkpoint_dir:
        os.makedirs(cfg.checkpoint_dir, exist_ok=True)
        cps = sorted(f for f in os.listdir(cfg.checkpoint_dir)
                     if f.startswith("checkpoint_iter")
                     and f.endswith(".npz")) if cfg.resume else []
        if cps:
            state = load_checkpoint(os.path.join(cfg.checkpoint_dir,
                                                 cps[-1]))
            start_it = min(state["iteration"] + 1,
                           max(cfg.iterations - 1, 0))
            recon = torch.as_tensor(state["recon"].data, dtype=f32,
                                    device=device)
            transforms = np.asarray(state["transforms"], np.float64)
            have_reference = True

    # ----- outer loop -----------------------------------------------------
    iterations, levels = cfg.iterations, cfg.multires_levels
    cur_lambda = cfg.lambda_
    eval_log = None if cfg.no_log else \
        open(cfg.log_prefix + "log-evaluation.txt", "a")
    try:
        for it in range(start_it, iterations):
            # registration (at iteration 0 only with a reference volume,
            # reconstruction.cc:826)
            if it > 0 or have_reference:
                have_pkgs = (len(cfg_packages) == n_stacks
                             and it <= iterations * (levels - 1) // levels
                             and it < iterations - 1)
                if have_pkgs:
                    recon_img = Image(recon.cpu().numpy(), recon_attr.copy())
                    kw = dict(use_nmi=cfg.use_nmi, device=device)
                    if it == 2:
                        kw.update(evenodd=True)
                    elif it == 3:
                        kw.update(evenodd=True, half=True)
                    elif it != 1:
                        kw.update(evenodd=True, half=True, half_iter=it - 2)
                    transforms = package_to_volume(
                        stacks, cfg_packages, recon_img, transforms, **kw)
                    # after the deeper halving, slice-to-volume follows
                    have_pkgs = it in (1, 2, 3)
                    sample("package registration")
                if not have_pkgs:
                    if reg_targets is None:
                        reg_targets, reg_mo, reg_ofs = [
                            torch.as_tensor(a, device=device)
                            for a in prepare_registration_slices(
                                batch, recon_attr.dx, device=device)]
                        sample("registration prep")
                    new_t, _ = s2v.register_slices_to_volume(
                        reg_cfg, recon, recon_w2i,
                        torch.as_tensor(transforms, dtype=f32,
                                        device=device),
                        reg_mo, reg_ofs, reg_targets, recon_attr.dx)
                    transforms = new_t.cpu().numpy().astype(np.float64)
                    sample("registration")

            # smoothing schedule (reconstruction.cc:893-911); lambda
            # persists between level boundaries
            if it == iterations - 1:
                cur_lambda = cfg.last_iter_lambda
            else:
                lam_l = cfg.lambda_
                for i in range(levels):
                    if it == iterations * (levels - i - 1) // levels:
                        cur_lambda = lam_l
                    lam_l *= 2
            alpha, lam = smoothing_parameters(cfg.delta, cur_lambda)
            rec_iterations = (cfg.rec_iterations_first
                              if it < iterations - 1
                              else cfg.rec_iterations_last)

            # geometry + initial volume
            geom, sume = svr_core.build_geometry(
                ctx, recon_w2i,
                torch.as_tensor(transforms, dtype=f32, device=device),
                slice_i2w, valid, mask_flat, stack_id=stack_id,
                slice_dims=slice_dims)
            em = svr_core.init_em_state(n, valid)
            recon, vol_weights, voxel_count = \
                svr_core.gaussian_reconstruction(ctx, geom, sume, slices,
                                                 valid, em.bias, em.scale,
                                                 mask_flat)
            sample("gaussian reconstruction")

            # exclude slices with small ROI overlap
            vc = voxel_count.cpu().numpy()
            median = np.sort(vc)[int(round(len(vc) * 0.5))]
            small_slices = vc < 0.1 * median
            excluded = torch.as_tensor(force_excluded | small_slices,
                                       device=device)

            sim_state = svr_core.simulate(ctx, geom, sume, recon, mask_flat)
            em = svr_core.initialize_robust_statistics(
                ctx, slices, valid, sim_state, em, max_i, min_i, excluded)
            em, _ = svr_core.estep(ctx, slices, valid, sume, sim_state, em,
                                   excluded)
            sample("simulate+estep")

            for sr_it in range(rec_iterations):
                em, sim_state, recon = svr_core.inner_iteration(
                    ctx, geom, sume, slices, valid, em, sim_state, recon,
                    vol_weights, mask_t, mask_flat, excluded, alpha, lam,
                    min_i, max_i, sr_it + 1, do_bias=do_bias,
                    do_scale=cfg.intensity_matching,
                    do_normalise_bias=do_nbias)
            sample("superresolution loop")
            recon = mask_volume(recon, mask_t)
            if manual_img is None:  # --manualMask reads the last geometry
                del geom

            # per-iteration observability (reconstruction.cc:1192, Evaluate
            # .cc:4540, the Save* dumps) and the checkpoint
            sw = em.slice_weight.cpu().numpy()
            if eval_log is not None:
                eval_log.write(f"Iteration {it}:\n" + _inclusion_lists(
                    sw, sim_state.slice_inside.cpu().numpy()) + "\n")
                eval_log.flush()
            if cfg.debug:
                for name, v in (("recon", recon), ("weights", em.weights),
                                ("scale", em.scale),
                                ("slice_weight", em.slice_weight),
                                ("sim", sim_state.sim)):
                    if not bool(torch.isfinite(v).all()):
                        raise FloatingPointError(
                            f"iteration {it}: {name} is not finite")
                write_nifti(Image(recon.cpu().numpy(), recon_attr.copy()),
                            f"{cfg.log_prefix}image{it}.nii.gz")
                write_nifti(Image(vol_weights.cpu().numpy(),
                                  recon_attr.copy()),
                            f"{cfg.log_prefix}confidence_map{it}.nii.gz")
                np.savez(f"{cfg.log_prefix}em_state{it}.npz",
                         slice_weights=sw, scales=em.scale.cpu().numpy(),
                         bias=em.bias.cpu().numpy(),
                         voxel_weights=em.weights.cpu().numpy())
            if cfg.checkpoint_dir:
                save_checkpoint(
                    f"{cfg.checkpoint_dir}/checkpoint_iter{it:03d}.npz", it,
                    Image(recon.cpu().numpy(), recon_attr.copy()),
                    transforms, slice_weights=sw,
                    scales=em.scale.cpu().numpy(),
                    stack_factors=stack_factors)
            if iteration_hook is not None:
                iteration_hook(it, Image(recon.cpu().numpy(),
                                         recon_attr.copy()),
                               np.asarray(transforms))
            sample("iteration tail")
    finally:
        if eval_log is not None:
            eval_log.close()

    # ----- final intensity restoration: RestoreSliceIntensities (.cc:1003)
    # + ScaleVolume (.cc:1034)
    factors = torch.as_tensor(stack_factors, device=device)[stack_id]
    restored = torch.where(slices > 0, slices / factors[:, None, None],
                           slices)
    scale = scale_volume_factor(restored, valid, em.weights, em.slice_weight,
                                sim_state.sim, sim_state.simw)
    recon = torch.where(recon > 0, recon * scale, recon)
    sample("restore+scale")

    # --manualMask: push the first stack's manual segmentation through the
    # PSF with the final geometry (transformManualMaskwithPSF, .cc:4824),
    # normalised over that stack's slices only
    manual_vol = None
    if manual_img is not None:
        mslices = np.zeros_like(batch.data)
        idx0 = np.nonzero(batch.stack_index == 0)[0]
        for j, k in enumerate(idx0[:manual_img.attr.z]):
            im = manual_img.data[j]
            mslices[k, :im.shape[0], :im.shape[1]] = im
        first = torch.as_tensor(batch.stack_index == 0, device=device)
        mvol = transform_manual_mask(
            ctx, geom, sume, torch.as_tensor(mslices, device=device),
            valid & first[:, None, None], mask_flat)
        manual_vol = Image(mvol.cpu().numpy(), recon_attr.copy())
        sample("manual mask transform")

    # --bspline: a smooth volume fitted by multi-level B-splines to the
    # restored slice samples at their final positions
    # (irtkBSplineReconstruction.cc:76; off the main path).  The sample
    # positions are formed in numpy float32, as in JAX.
    bspline_vol = None
    if cfg.bspline:
        fwd = svr_core.slice_forward_matrices(
            recon_w2i, torch.as_tensor(transforms, dtype=f32, device=device),
            slice_i2w).cpu().numpy()
        _, hb, wb = batch.data.shape
        px, py = np.meshgrid(np.arange(wb, dtype=np.float32),
                             np.arange(hb, dtype=np.float32))
        pos = (fwd[:, None, None, :3, 0] * px[None, :, :, None]
               + fwd[:, None, None, :3, 1] * py[None, :, :, None]
               + fwd[:, None, None, :3, 3])
        rest = restored.cpu().numpy()
        keep = rest > 0
        bvol = bspline_reconstruct(pos[keep], rest[keep],
                                   recon_attr.shape_zyx, device=device)
        bvol = torch.where(mask_t != 0, bvol, 0.0)
        bspline_vol = Image(bvol.cpu().numpy(), recon_attr.copy())
        sample("bspline reconstruction")

    return SVRResult(
        reconstructed=Image(recon.cpu().numpy(), recon_attr.copy()),
        transforms=transforms, slice_weights=em.slice_weight.cpu().numpy(),
        stack_factors=stack_factors, stats=stats,
        excluded_slices=list(np.nonzero(small_slices)[0]),
        slice_inside=sim_state.slice_inside.cpu().numpy(),
        manual_mask_volume=manual_vol, bspline_reconstructed=bspline_vol)
