"""GoMatching meta-architecture: frozen spotter + rescoring + tracker head; and the
spotter-pretraining meta-architecture.

Port of ``gomatching_tpu/models/gomatching.py`` (reference ``GoMatching``,
gomatching/modeling/meta_arch/gom_lstmatcher.py:113, and ``TransformerPureDetector``,
third_party/adet/modeling/text_spotter.py:106), on the ResNet, Swin-T/S or ViTAEv2-S
trunk (``MODEL.BACKBONE.NAME``).

  spot_and_detect(images (B, H, W, 3) normalized, NHWC) ->
      per-frame arrays over the fixed query-slot axis + a validity mask

covering backbone -> 2D sine position encoding -> DeepSolo spotter -> rescoring head
-> score fusion max(score, re_score) (gom_lstmatcher.py:595-599) -> threshold -> NMS
keep-mask (:316-326) -> reid embedding (lstmatcher.py:280-290). The sequential
association lives in ``tracking/tracker.py`` on the host; ``associate`` runs the
matcher transformer on the device: GoMatching's long/short-term matchers or
GoMatching++'s shared one (``ROI_HEADS.NAME`` SHA_FFN_CRSATTN).

Submodule names follow the reference checkpoint: ``backbone.0.backbone`` (the
Joiner/MaskedBackbone nesting), ``detection_transformer``, ``roi_heads``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn as nn

from ..ops.nms import nms_mask
from ..utils.profiling import span
from .lst_matcher import LSTMatcherHead
from .pos_encoding import position_encoding_2d
from .resnet import FrozenBN, ResNet
from .spotter import DeepSoloSpotter
from .swin import SWIN_DEPTHS, SwinTransformer
from .vitae import ViTAEv2

BACKBONE_CHANNELS = {
    "build_resnet_backbone": (512, 1024, 2048),
    "build_swin_backbone": (192, 384, 768),
    "build_vitaev2_backbone": (128, 256, 512),
}
PRECISIONS = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FROZEN_SUBMODULES = ("backbone", "detection_transformer")  # what MODEL.PRECISION casts
# the tracker head's matcher modules, which TPU.ASSOC_PRECISION casts (JAX predictor.py:51-57);
# reid (asso_head) and rescore feed the spot path and stay f32
MATCHER_SUBMODULES = ("long_term_matcher", "short_term_matcher", "shared_matcher",
                      "asso_predictor", "local_asso_predictor")
BACKBONE_STRIDES = (8, 16, 32)


class MaskedBackbone(nn.Module):
    """Holds the trunk under the reference's ``backbone.0.backbone`` prefix."""

    def __init__(self, backbone: nn.Module):
        super().__init__()
        self.backbone = backbone


def level_masks(pad_hw, image_hw: Optional[torch.Tensor]) -> Optional[List[torch.Tensor]]:
    """Padding masks (B, ceil(H / s), ceil(W / s)) per backbone stride s, True where
    padded, from the true (h, w) of each frame ``image_hw`` (B, 2) on a ``pad_hw``
    canvas (MaskedBackbone.mask_out_padding, gom_lstmatcher.py:63-76; JAX
    ``GoMatchingModel._level_masks``, gomatching.py:138). None when ``image_hw`` is."""
    if image_hw is None:
        return None
    hw = image_hw.float()
    masks = []
    for stride in BACKBONE_STRIDES:
        fh, fw = -(-pad_hw[0] // stride), -(-pad_hw[1] // stride)
        vh = torch.ceil(hw[:, 0] / stride)
        vw = torch.ceil(hw[:, 1] / stride)
        yy = torch.arange(fh, dtype=torch.float32, device=hw.device)[None, :, None]
        xx = torch.arange(fw, dtype=torch.float32, device=hw.device)[None, None, :]
        masks.append(~((yy < vh[:, None, None]) & (xx < vw[:, None, None])))
    return masks


def build_trunk(name: str, resnet_depth: int = 50, swin_type: str = "tiny",
                swin_drop_path: float = 0.0) -> nn.Module:
    """The trunk ``MODEL.BACKBONE.NAME`` names (JAX gomatching.py:84-97, :302-316)."""
    if name == "build_resnet_backbone":
        return ResNet(resnet_depth, ("res3", "res4", "res5"))
    if name == "build_swin_backbone":
        return SwinTransformer(depths=SWIN_DEPTHS[swin_type], drop_path_rate=swin_drop_path)
    if name == "build_vitaev2_backbone":
        return ViTAEv2()
    raise ValueError(f"MODEL.BACKBONE.NAME={name!r}: expected one of {sorted(BACKBONE_CHANNELS)}")


def _promoted(x: torch.Tensor, module: nn.Module) -> torch.Tensor:
    """``x`` in the wider of its dtype and ``module``'s parameters': flax promotes a bf16
    input against f32 weights to f32 (JAX predictor.py:37-38), where torch would raise."""
    return x.to(torch.promote_types(x.dtype, next(module.parameters()).dtype))


def backbone_features(backbone: nn.Module, images: torch.Tensor, hidden_dim: int,
                      temperature: float, masks: Optional[List[torch.Tensor]] = None,
                      generator: Optional[torch.Generator] = None):
    """NHWC normalized images -> (res3..5 NCHW features, NHWC position encodings);
    ``masks`` (True where padded, one per level) shape the encodings when given.
    ``generator``: the Swin trunk's drop-path randomness (pretraining only)."""
    trunk = backbone[0].backbone
    x = _promoted(images.permute(0, 3, 1, 2).contiguous(), trunk)
    with span("trunk"):
        feats = trunk(x, generator) if generator is not None else trunk(x)
    feats = [feats["res3"], feats["res4"], feats["res5"]]
    pos = [
        position_encoding_2d((f.shape[0], f.shape[2], f.shape[3]), hidden_dim // 2,
                             temperature, None if masks is None else masks[i], device=f.device)
        for i, f in enumerate(feats)
    ]
    return feats, pos


class GoMatchingModel(nn.Module):
    """Backbone + spotter + tracker head."""

    def __init__(self, resnet_depth=50, hidden_dim=256, n_heads=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=1024, num_feature_levels=4,
                 enc_n_points=4, dec_n_points=4, num_queries=100, num_points=25, voc_size=37,
                 temperature=10000.0, boundary_head=True, backbone_name="build_resnet_backbone",
                 swin_type="tiny", asso_feature_dim=1024, asso_num_fc=2,
                 asso_num_heads=8, asso_num_encoder_layers=1, asso_num_decoder_layers=1,
                 asso_num_weight_layers=0, asso_variant="lst", asso_no_pos_emb=True,
                 asso_with_temp_emb=False, with_rescore=True, test_score_threshold=0.3,
                 nms_thresh=0.5, sampling_impl="vmem", asso_dropout=0.0, asso_dropout_seed=0):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.temperature = float(temperature)
        self.with_rescore = with_rescore
        self.test_score_threshold = test_score_threshold
        self.nms_thresh = nms_thresh
        self.backbone = nn.Sequential(
            MaskedBackbone(build_trunk(backbone_name, resnet_depth, swin_type)))
        self.detection_transformer = DeepSoloSpotter(
            d_model=hidden_dim, n_heads=n_heads, num_encoder_layers=num_encoder_layers,
            num_decoder_layers=num_decoder_layers, dim_feedforward=dim_feedforward,
            num_feature_levels=num_feature_levels, enc_n_points=enc_n_points,
            dec_n_points=dec_n_points, num_queries=num_queries, num_points=num_points,
            voc_size=voc_size, temperature=temperature,
            in_channels=BACKBONE_CHANNELS[backbone_name], boundary_head=boundary_head,
            sampling_impl=sampling_impl,
        )
        self.roi_heads = LSTMatcherHead(
            hidden_dim=hidden_dim, num_points=num_points, feature_dim=asso_feature_dim,
            num_fc=asso_num_fc, num_heads=asso_num_heads,
            num_encoder_layers=asso_num_encoder_layers,
            num_decoder_layers=asso_num_decoder_layers,
            num_weight_layers=asso_num_weight_layers, variant=asso_variant,
            with_rescore=with_rescore, no_pos_emb=asso_no_pos_emb,
            with_temp_emb=asso_with_temp_emb, dropout=asso_dropout,
            dropout_seed=asso_dropout_seed,
        )
        self.compute_dtype = torch.float32  # the frozen spotter's; see cast_frozen_

    def cast_frozen_(self, dtype: torch.dtype,
                     members: Sequence[str] = FROZEN_SUBMODULES) -> "GoMatchingModel":
        """Run the frozen spotter (``backbone`` and ``detection_transformer``, every
        parameter and buffer, the FrozenBN statistics too) in ``dtype``, as JAX's
        ``cast_frozen_params`` does (predictor.py:35-46); ``roi_heads`` stays as it is.
        ``members``: the frozen ones of the two, which alone the tracker trainer casts
        (JAX train.py:253-260): under FREEZE_TYPE Backbone only the trunk, under '' none.
        The frames and position encodings go to ``dtype`` in ``spot`` all the same. The
        Bernstein basis is a constant of the computation, not a parameter, and stays f32
        (JAX spotter.py:555)."""
        for name in members:
            getattr(self, name).to(dtype)
        spotter = self.detection_transformer
        spotter.bernstein = spotter.bernstein.float()
        self.compute_dtype = dtype
        return self

    def cast_matcher_(self, dtype: torch.dtype) -> "GoMatchingModel":
        """The association matchers and affinity heads in ``dtype`` (JAX
        ``cast_assoc_params``, predictor.py:60-74); reid and rescore stay f32."""
        for name in MATCHER_SUBMODULES:
            if hasattr(self.roi_heads, name):
                getattr(self.roi_heads, name).to(dtype)
        return self

    def features(self, images: torch.Tensor, masks: Optional[List[torch.Tensor]] = None):
        """NHWC normalized images -> (res3..5 NCHW features, NHWC position encodings)."""
        return backbone_features(self.backbone, images, self.hidden_dim, self.temperature,
                                 masks)

    def spot(self, images: torch.Tensor,
             image_hw: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Backbone + spotter (+ rescoring head) on normalized NHWC frames (JAX
        gomatching.py:155-180). ``image_hw`` (B, 2): each frame's true (h, w) on the
        zero-padded canvas; the level masks it gives reach the position encodings and
        the spotter (its masked encoder samples through B1). None: the whole canvas is
        valid and nothing is masked. The frames and the position encodings (computed f32)
        go to ``compute_dtype``; a part of the spotter whose weights are wider computes
        at their dtype, as flax promotes a bf16 input against f32 weights (the frozen
        bf16 trunk of FREEZE_TYPE Backbone feeds an f32 spotter); the rescoring head
        computes at the f32 of its weights."""
        dtype = self.compute_dtype
        masks = level_masks(images.shape[1:3], image_hw)
        feats, pos = self.features(images.to(dtype), masks)
        spotter = self.detection_transformer
        out = spotter([_promoted(f, spotter) for f in feats], [p.to(dtype) for p in pos], masks)
        out["re_pred_logits"] = (
            self.roi_heads.rescore(out["query_features"].float()) if self.with_rescore else None
        )
        return out

    def detect(self, out: Dict[str, torch.Tensor], image_hw_scale: torch.Tensor,
               score_thresh: Optional[float] = None) -> Dict[str, torch.Tensor]:
        """Score fusion + threshold + NMS + reid over the query-slot axis
        (GoMatching.detection, gom_lstmatcher.py:579-651; NMS :299-332; reid
        lstmatcher.py:271-290). ``image_hw_scale`` (B, 2) true (h, w)."""
        scores = out["pred_logits"].float().mean(2)[..., 0].sigmoid()  # (B, nq)
        if out["re_pred_logits"] is not None:
            re = out["re_pred_logits"].float().mean(2)[..., 0].sigmoid()
            final_scores = torch.maximum(scores, re)
        else:
            final_scores = scores
        hw = image_hw_scale.float()
        wh = torch.stack([hw[:, 1], hw[:, 0]], -1)[:, None, None, :]  # (B, 1, 1, 2)
        ctrl = out["pred_ctrl_points"].float() * wh
        recs = out["pred_text_logits"].argmax(-1).int()  # (B, nq, npts)
        bd = out["pred_bd_points"].float() * torch.cat([wh, wh], -1)
        pts = bd.reshape(*bd.shape[:2], -1, 2)  # (B, nq, 2*npts, 2)
        boxes = torch.stack(
            [pts[..., 0].amin(-1), pts[..., 1].amin(-1), pts[..., 0].amax(-1), pts[..., 1].amax(-1)],
            -1,
        )
        thresh = self.test_score_threshold if score_thresh is None else score_thresh
        sel = final_scores > thresh
        with span("spot.nms"):
            valid = sel & nms_mask(boxes, final_scores, sel, self.nms_thresh)
        return {
            "scores": final_scores,
            "valid": valid,
            "boxes": boxes,
            "ctrl_points": ctrl.flatten(2),
            "recs": recs,
            "bd": bd,
            "reid": self.roi_heads.reid(out["query_features"].float()),
        }

    def spot_and_detect(self, images: torch.Tensor, score_thresh: Optional[float] = None):
        out = self.spot(images)
        b, h, w = images.shape[:3]
        hw = torch.tensor([[h, w]], dtype=torch.float32, device=images.device).expand(b, 2)
        return self.detect(out, hw, score_thresh)

    def associate(self, reid_tokens, valid, short_term: bool, boxes=None, times=None,
                  train: bool = False):
        """Padded association transformer pass (LSTMatcherHead.associate); ``train``
        applies ASSO_HEAD.DROPOUT when the head is in ``train()`` mode."""
        return self.roi_heads.associate(reid_tokens, valid, short_term, boxes, times, train)


class SpotterPretrainModel(nn.Module):
    """Spotter pretraining meta-arch (JAX ``SpotterPretrainModel``,
    gomatching_tpu/models/gomatching.py:271): backbone + DeepSolo spotter emitting the
    last-layer, aux-layer and encoder outputs ``SpotterCriterion`` reads; no tracker
    head, and the whole model trains, FrozenBN tensors included as in JAX. Image
    pretraining feeds square canvases with nothing padded; video pretraining
    (TransformerPureVideoDetector) a clip's padded canvas with each frame's true size,
    which gives the padding masks. ``swin_drop_path``: the Swin trunk's drop-path rate
    (``SWIN.DROP_PATH_RATE``), applied only when ``forward`` gets a generator."""

    def __init__(self, resnet_depth=50, hidden_dim=256, n_heads=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=1024, num_feature_levels=4,
                 enc_n_points=4, dec_n_points=4, num_queries=100, num_points=25, voc_size=37,
                 temperature=10000.0, boundary_head=True, backbone_name="build_resnet_backbone",
                 swin_type="tiny", swin_drop_path=0.0):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.temperature = float(temperature)
        self.backbone = nn.Sequential(MaskedBackbone(
            build_trunk(backbone_name, resnet_depth, swin_type, swin_drop_path)))
        for mod in self.backbone.modules():
            if isinstance(mod, FrozenBN):
                mod.make_trainable_()
        self.detection_transformer = DeepSoloSpotter(
            d_model=hidden_dim, n_heads=n_heads, num_encoder_layers=num_encoder_layers,
            num_decoder_layers=num_decoder_layers, dim_feedforward=dim_feedforward,
            num_feature_levels=num_feature_levels, enc_n_points=enc_n_points,
            dec_n_points=dec_n_points, num_queries=num_queries, num_points=num_points,
            voc_size=voc_size, temperature=temperature,
            in_channels=BACKBONE_CHANNELS[backbone_name], boundary_head=boundary_head,
        )

    def forward(self, images: torch.Tensor, image_hw: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict:
        """NHWC normalized images (B, H, W, 3) -> the spotter's training outputs.
        ``image_hw`` (B, 2): each frame's true (h, w) on the padded canvas, from which the
        level masks come (JAX gomatching.py:343-360); None: nothing is padded.
        ``generator``: drop-path's random source for a Swin trunk (JAX ``train=True``
        with a 'dropout' rng); None runs the trunk deterministically."""
        masks = level_masks(images.shape[1:3], image_hw)
        feats, pos = backbone_features(self.backbone, images, self.hidden_dim, self.temperature,
                                       masks, generator)
        return self.detection_transformer(feats, pos, masks, train_outputs=True)


def compute_dtype(cfg) -> torch.dtype:
    """The frozen spotter's dtype, ``MODEL.PRECISION``."""
    if cfg.MODEL.PRECISION not in PRECISIONS:
        raise ValueError(f"MODEL.PRECISION={cfg.MODEL.PRECISION!r}: expected one of "
                         f"{sorted(PRECISIONS)}")
    return PRECISIONS[cfg.MODEL.PRECISION]


def _spotter_kwargs(cfg) -> Dict:
    t = cfg.MODEL.TRANSFORMER
    return dict(
        resnet_depth=cfg.MODEL.RESNETS.DEPTH, hidden_dim=t.HIDDEN_DIM, n_heads=t.NHEADS,
        num_encoder_layers=t.ENC_LAYERS, num_decoder_layers=t.DEC_LAYERS,
        dim_feedforward=t.DIM_FEEDFORWARD, num_feature_levels=t.NUM_FEATURE_LEVELS,
        enc_n_points=t.ENC_N_POINTS, dec_n_points=t.DEC_N_POINTS, num_queries=t.NUM_QUERIES,
        num_points=t.NUM_POINTS, voc_size=t.VOC_SIZE, temperature=float(t.TEMPERATURE),
        boundary_head=t.BOUNDARY_HEAD, sampling_impl=cfg.TPU.SAMPLING_IMPL,
        backbone_name=cfg.MODEL.BACKBONE.NAME, swin_type=cfg.MODEL.SWIN.TYPE,
    )


def build_pretrain_model(cfg) -> SpotterPretrainModel:
    """The spotter-pretraining model of a reference-schema config (any trunk). The
    sampler is always the exact differentiable one (B1/B2 forwards, B3/B4 backwards on
    CUDA), whatever ``TPU.SAMPLING_IMPL`` says: B5 ('pallas') has no backward, and JAX
    too trains through another sampler when 'pallas' is asked for
    (gomatching_tpu/config.py:417-425). ``TPU.TRAIN_SAMPLING_IMPL`` is not read, nor is
    ``MODEL.PRECISION``: pretraining runs f32 whatever it says, as JAX's pretraining
    model takes no compute dtype (gomatching_tpu/models/gomatching.py:271). A Swin trunk
    takes ``SWIN.DROP_PATH_RATE`` (JAX gomatching.py:306-311); only this model reads it."""
    kwargs = _spotter_kwargs(cfg)
    del kwargs["sampling_impl"]
    return SpotterPretrainModel(**kwargs, swin_drop_path=float(cfg.MODEL.SWIN.DROP_PATH_RATE))


MATCHER_VARIANTS = {"LSTMatcher": "lst", "SHA_FFN_CRSATTN": "shared"}


def build_model(cfg) -> GoMatchingModel:
    """Construct the meta-arch from a reference-schema config (any of the three trunks):
    GoMatching (``ROI_HEADS.NAME`` LSTMatcher) or GoMatching++ (SHA_FFN_CRSATTN), with
    or without the matcher's positional embeddings (JAX gomatching.py:400-441). The model
    is built f32: ``cast_frozen_`` puts the spotter in ``compute_dtype(cfg)``, which this
    checks."""
    compute_dtype(cfg)
    if cfg.MODEL.ROI_HEADS.NAME not in MATCHER_VARIANTS:
        raise ValueError(f"ROI_HEADS.NAME={cfg.MODEL.ROI_HEADS.NAME}: expected one of "
                         f"{sorted(MATCHER_VARIANTS)}")
    t = cfg.MODEL.TRANSFORMER
    a = cfg.MODEL.ASSO_HEAD
    return GoMatchingModel(
        **_spotter_kwargs(cfg), asso_feature_dim=a.FC_DIM, asso_num_fc=a.NUM_FC,
        asso_num_heads=a.NUM_HEADS, asso_num_encoder_layers=a.NUM_ENCODER_LAYERS,
        asso_num_decoder_layers=a.NUM_DECODER_LAYERS,
        asso_num_weight_layers=a.NUM_WEIGHT_LAYERS,
        asso_variant=MATCHER_VARIANTS[cfg.MODEL.ROI_HEADS.NAME],
        asso_no_pos_emb=a.NO_POS_EMB, asso_with_temp_emb=a.WITH_TEMP_EMB,
        with_rescore=cfg.MODEL.ROI_HEADS.WITH_RESR,
        test_score_threshold=t.INFERENCE_TH_TEST, nms_thresh=cfg.VIDEO_TEST.NMS_THRESH,
        asso_dropout=a.DROPOUT, asso_dropout_seed=max(int(cfg.SEED), 0),
    )
