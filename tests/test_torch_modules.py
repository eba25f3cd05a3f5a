"""Module-by-module parity of the PyTorch port against the JAX package, on the
CPU in float32 at small sizes: the same numpy inputs through the flax module
and its port twin, the flax parameters carried over, atol = rtol = 1e-4 (the
JAX suite's own tolerance). Batch 2 wherever time folds into batch."""
import numpy as np
import pytest
import torch

import neurips2023_soc_tpu.models.common as jc
import neurips2023_soc_tpu.models.deformable_transformer as jdt
import neurips2023_soc_tpu.models.position_encoding as jpe
import neurips2023_soc_tpu.models.segmentation as jseg
import neurips2023_soc_tpu.ops.resize as jrs
import neurips2023_soc_tpu.utils.boxes as jbx
import neurips2023_soc_torch.models.common as tc
import neurips2023_soc_torch.models.deformable_transformer as tdt
import neurips2023_soc_torch.models.position_encoding as tpe
import neurips2023_soc_torch.models.segmentation as tseg
import neurips2023_soc_torch.ops.resize as trs
import neurips2023_soc_torch.utils.boxes as tbx

from torch_port_helpers import apply_jax, close, generic_state_dict, init_jax, load, \
    run_jax, soc_state_dict, t
from torch_port_helpers import torch_threads_per_worker  # noqa: F401 (autouse)

RNG = np.random.RandomState


def _case_resize():
    x = RNG(0).randn(2, 5, 7, 3).astype(np.float32)
    close(trs.resize_nearest(t(x), 9, 4), run_jax(jrs.resize_nearest, x, 9, 4))
    close(trs.resize_nearest(t(x), 3, 3), run_jax(jrs.resize_nearest, x, 3, 3))
    for ac in (False, True):
        close(trs.resize_bilinear(t(x), 11, 13, ac), run_jax(jrs.resize_bilinear, x, 11, 13, ac))
        close(trs.resize_bilinear(t(x), 3, 2, ac), run_jax(jrs.resize_bilinear, x, 3, 2, ac))
    for f in (1, 2, 4):
        close(trs.aligned_bilinear(t(x), f), run_jax(jrs.aligned_bilinear, x, f))
    m = RNG(1).rand(2, 9, 13) > 0.5
    np.testing.assert_array_equal(trs.downsample_mask_nearest(t(m), 4, 5).numpy(),
                                  np.asarray(jrs.downsample_mask_nearest(m, 4, 5)))


def _case_position_encoding():
    pad1 = np.zeros((2, 9), bool)
    pad1[1, 6:] = True
    close(tpe.position_embedding_sine_1d(t(pad1), 16),
          run_jax(jpe.position_embedding_sine_1d, pad1, 16))
    pad2 = np.zeros((2, 6, 7), bool)
    pad2[1, 4:] = True
    pad2[1, :, 5:] = True
    close(tpe.position_embedding_sine_2d(t(pad2), 8),
          run_jax(jpe.position_embedding_sine_2d, pad2, 8))


def _case_multihead_attention():
    rng = RNG(2)
    q = rng.randn(2, 5, 16).astype(np.float32)
    kv = rng.randn(2, 7, 16).astype(np.float32)
    kpm = np.zeros((2, 7), bool)
    kpm[1, 4:] = True
    add = rng.randn(2 * 4, 5, 7).astype(np.float32)
    blocked = rng.rand(5, 7) > 0.7
    blocked[:, 0] = False
    jm = jc.MultiheadAttention(16, 4)
    params = init_jax(jm, q, kv, kv)
    tm = load(tc.MultiheadAttention(16, 4), generic_state_dict(params))
    for kw in (dict(key_padding_mask=kpm), dict(attn_mask=add), dict(attn_mask=blocked)):
        want = apply_jax(jm, params, q, kv, kv, **kw)
        close(tm(t(q), t(kv), t(kv), **{k: t(v) for k, v in kw.items()}), want)


def _case_mlp_and_resizer():
    x = RNG(3).randn(2, 5, 12).astype(np.float32)
    jm = jc.MLP(16, 4, 3)
    params = init_jax(jm, x)
    close(load(tc.MLP(12, 16, 4, 3), generic_state_dict(params))(t(x)),
          apply_jax(jm, params, x))
    jr = jc.FeatureResizer(16)
    params = init_jax(jr, x)
    close(load(tc.FeatureResizer(12, 16), generic_state_dict(params))(t(x)),
          apply_jax(jr, params, x))


def _case_fusion_layers():
    rng = RNG(4)
    tgt = rng.randn(2, 6, 16).astype(np.float32)
    mem = rng.randn(2, 9, 16).astype(np.float32)
    pos = rng.randn(2, 9, 16).astype(np.float32)
    qpos = rng.randn(2, 6, 16).astype(np.float32)
    kpm = np.zeros((2, 9), bool)
    kpm[0, 7:] = True
    for jm, tm, args, kw in (
        (jc.MMF(16, 4), tc.MMF(16, 4), (tgt, mem),
         dict(memory_key_padding_mask=kpm, pos=pos, query_pos=qpos)),
        (jc.CrossAttentionLayer(16, 4), tc.CrossAttentionLayer(16, 4), (tgt, mem),
         dict(memory_key_padding_mask=kpm, pos=pos, query_pos=qpos)),
        (jc.SelfAttentionLayer(16, 4), tc.SelfAttentionLayer(16, 4), (tgt,),
         dict(query_pos=qpos)),
        (jc.FFNLayer(16, 32), tc.FFNLayer(16, 32), (tgt,), {}),
        (jc.FFNLayer(16, 32, activation="gelu"), tc.FFNLayer(16, 32, activation="gelu"),
         (tgt,), {}),
    ):
        params = init_jax(jm, *args, **kw)
        want = apply_jax(jm, params, *args, **kw)
        got = load(tm, generic_state_dict(params))(
            *map(t, args), **{k: t(v) for k, v in kw.items()})
        close(got, want)


SHAPES = ((6, 8), (3, 4), (2, 2), (1, 1))


def _case_msdeform_attn_module():
    rng = RNG(5)
    S = sum(h * w for h, w in SHAPES)
    query = rng.randn(2, 7, 32).astype(np.float32)
    src = rng.randn(2, S, 32).astype(np.float32)
    pad = rng.rand(2, S) > 0.8
    jm = jdt.MSDeformAttnModule(32, 4, 4, 2)
    for ref in (rng.rand(2, 7, 4, 2).astype(np.float32),
                rng.rand(2, 7, 4, 4).astype(np.float32)):
        params = init_jax(jm, query, ref, src, SHAPES, pad)
        # the init is zero kernels + grid bias; perturb so the offsets and
        # weights depend on the query
        params = {k: {n: a + 0.1 * rng.randn(*a.shape).astype(np.float32)
                      for n, a in v.items()} for k, v in params.items()}
        tm = load(tdt.MSDeformAttnModule(32, 4, 4, 2), generic_state_dict(params))
        want = apply_jax(jm, params, query, ref, src, SHAPES, pad)
        got = tm(t(query), t(ref), t(src), SHAPES, t(pad))
        for g, w in zip(got, want):
            close(g, w)


def _transformer_inputs(seed, C=32):
    rng = RNG(seed)
    shapes = ((8, 10), (4, 5), (2, 3), (1, 2))
    srcs = [rng.randn(2, h, w, C).astype(np.float32) for h, w in shapes]
    poses = [rng.randn(2, h, w, C).astype(np.float32) for h, w in shapes]
    masks = []
    for h, w in shapes:
        m = np.zeros((2, h, w), bool)
        m[1, max(1, int(h * 0.75)):] = True
        m[1, :, max(1, int(w * 0.8)):] = True
        masks.append(m)
    return srcs, masks, poses, rng.randn(5, C).astype(np.float32)


def _check_transformer(two_stage):
    srcs, masks, poses, qe = _transformer_inputs(6)
    kw = dict(d_model=32, n_heads=4, num_encoder_layers=2, num_decoder_layers=2,
              dim_feedforward=64, num_feature_levels=4, dec_n_points=2, enc_n_points=2,
              two_stage=two_stage, two_stage_num_proposals=6)
    jm = jdt.DeformableTransformer(dropout=0.0, with_box_refine=True, **kw)
    qe_j = None if two_stage else qe
    params = init_jax(jm, srcs, masks, poses, qe_j)
    want = apply_jax(jm, params, srcs, masks, poses, qe_j)
    sd = soc_state_dict(params, "transformer", "transformer.")
    heads = {k[len("bbox_embed."):]: sd.pop(k) for k in list(sd)
             if k.startswith("bbox_embed.")}
    bbox_embed = load(torch.nn.ModuleList(tc.MLP(32, 32, 4, 3) for _ in range(2)), heads)
    tm = load(tdt.DeformableTransformer(**kw), sd)
    with torch.no_grad():
        got = tm([t(s) for s in srcs], [t(m) for m in masks], [t(p) for p in poses],
                 None if two_stage else t(qe), bbox_embed)
    for g, w in zip(got[:4], want[:4]):
        if isinstance(g, list):
            for gi, wi in zip(g, w):
                close(gi, wi)
        else:
            close(g, w)
    if two_stage:
        for g, w in zip(got[4], want[4]):
            close(g, w)


def _case_deformable_transformer():
    _check_transformer(two_stage=False)


def _case_deformable_transformer_two_stage():
    _check_transformer(two_stage=True)


def _case_segmentation():
    rng = RNG(7)
    C = 32
    x = rng.randn(4, 3, 4, C).astype(np.float32)
    feats = [rng.randn(4, 6, 8, C).astype(np.float32),
             rng.randn(4, 12, 16, C).astype(np.float32),
             rng.randn(4, 24, 32, 16).astype(np.float32)]
    jm = jseg.FPNSpatialDecoder(C, [C, C, 16], 8)
    params = init_jax(jm, x, feats)
    tm = load(tseg.FPNSpatialDecoder(C, [C, C, 16], 8),
              soc_state_dict(params, "spatial_decoder", "spatial_decoder."))
    mf_w = apply_jax(jm, params, x, feats)
    mf_t = tm(t(x), [t(f) for f in feats])
    close(mf_t, mf_w)
    B, T, Q = 2, 2, 3
    mf = mf_w.reshape(B, T, 24, 32, 8)
    nparams = sum(sum(s) for s in jseg.mask_head_param_split(8, 8, 3, True))
    head_params = (0.3 * rng.randn(B, T * Q, nparams)).astype(np.float32)
    refs = rng.rand(B, T * Q, 2).astype(np.float32)
    sizes = np.array([[96, 128], [80, 100]], np.float32)
    for size, stride_out in (((96, 128), 4), (sizes, 4), ((96, 128), 2)):
        want = run_jax(jseg.dynamic_mask_with_coords, mf, head_params, refs, size, 8, 3,
                       mask_out_stride=stride_out)
        got = tseg.dynamic_mask_with_coords(
            t(mf), t(head_params), t(refs), size if isinstance(size, tuple) else t(size),
            8, 3, mask_out_stride=stride_out)
        close(got, want)


def _case_boxes_ratios_locations():
    rng = RNG(8)
    b = rng.rand(3, 5, 4).astype(np.float32)
    close(tbx.box_cxcywh_to_xyxy(t(b)), run_jax(jbx.box_cxcywh_to_xyxy, b))
    close(tbx.box_xyxy_to_cxcywh(t(b)), run_jax(jbx.box_xyxy_to_cxcywh, b))
    x = rng.uniform(-0.1, 1.1, (4, 6)).astype(np.float32)
    close(tbx.inverse_sigmoid(t(x)), run_jax(jbx.inverse_sigmoid, x))
    _, masks, _, _ = _transformer_inputs(9)
    vr_w = run_jax(jdt.compute_valid_ratios, masks)
    close(tdt.compute_valid_ratios([t(m) for m in masks]), vr_w)
    shapes = tuple(m.shape[1:] for m in masks)
    close(tdt.encoder_reference_points(shapes, t(vr_w)),
          run_jax(jdt.encoder_reference_points, shapes, vr_w))
    close(tseg.compute_locations(5, 7, 4), run_jax(jseg.compute_locations, 5, 7, 4))
    props = rng.randn(2, 6, 4).astype(np.float32)
    close(tdt.proposal_pos_embed(t(props), 32), run_jax(jdt.proposal_pos_embed, props, 32))


CASES = {name[len("_case_"):]: fn for name, fn in globals().items()
         if name.startswith("_case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_module_parity(case):
    with torch.no_grad():
        CASES[case]()
