"""GoMatching meta-architecture: frozen spotter + rescoring + tracker head; and the
spotter-pretraining meta-architecture.

Port of ``gomatching_tpu/models/gomatching.py`` (reference ``GoMatching``,
gomatching/modeling/meta_arch/gom_lstmatcher.py:113, and ``TransformerPureDetector``,
third_party/adet/modeling/text_spotter.py:106), ResNet backbone only.

  spot_and_detect(images (B, H, W, 3) normalized, NHWC) ->
      per-frame arrays over the fixed query-slot axis + a validity mask

covering backbone -> 2D sine position encoding -> DeepSolo spotter -> rescoring head
-> score fusion max(score, re_score) (gom_lstmatcher.py:595-599) -> threshold -> NMS
keep-mask (:316-326) -> reid embedding (lstmatcher.py:280-290). The sequential
association lives in ``tracking/tracker.py`` on the host; ``associate`` runs the
matcher transformer on the device.

Submodule names follow the reference checkpoint: ``backbone.0.backbone`` (the
Joiner/MaskedBackbone nesting), ``detection_transformer``, ``roi_heads``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from ..utils.boxes import nms_mask
from .lst_matcher import LSTMatcherHead
from .pos_encoding import position_encoding_2d
from .resnet import FrozenBN, ResNet
from .spotter import DeepSoloSpotter

BACKBONE_CHANNELS = {"build_resnet_backbone": (512, 1024, 2048)}
BACKBONE_STRIDES = (8, 16, 32)


class MaskedBackbone(nn.Module):
    """Holds the trunk under the reference's ``backbone.0.backbone`` prefix."""

    def __init__(self, backbone: nn.Module):
        super().__init__()
        self.backbone = backbone


def backbone_features(backbone: nn.Module, images: torch.Tensor, hidden_dim: int,
                      temperature: float):
    """NHWC normalized images -> (res3..5 NCHW features, NHWC position encodings)."""
    feats = backbone[0].backbone(images.permute(0, 3, 1, 2).contiguous())
    feats = [feats["res3"], feats["res4"], feats["res5"]]
    pos = [
        position_encoding_2d((f.shape[0], f.shape[2], f.shape[3]), hidden_dim // 2,
                             temperature, None, device=f.device)
        for f in feats
    ]
    return feats, pos


class GoMatchingModel(nn.Module):
    """Backbone + spotter + tracker head."""

    def __init__(self, resnet_depth=50, hidden_dim=256, n_heads=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=1024, num_feature_levels=4,
                 enc_n_points=4, dec_n_points=4, num_queries=100, num_points=25, voc_size=37,
                 temperature=10000.0, boundary_head=True, asso_feature_dim=1024, asso_num_fc=2,
                 asso_num_heads=8, asso_num_encoder_layers=1, asso_num_decoder_layers=1,
                 asso_num_weight_layers=0, with_rescore=True, test_score_threshold=0.3,
                 nms_thresh=0.5):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.temperature = float(temperature)
        self.with_rescore = with_rescore
        self.test_score_threshold = test_score_threshold
        self.nms_thresh = nms_thresh
        self.backbone = nn.Sequential(
            MaskedBackbone(ResNet(resnet_depth, ("res3", "res4", "res5")))
        )
        self.detection_transformer = DeepSoloSpotter(
            d_model=hidden_dim, n_heads=n_heads, num_encoder_layers=num_encoder_layers,
            num_decoder_layers=num_decoder_layers, dim_feedforward=dim_feedforward,
            num_feature_levels=num_feature_levels, enc_n_points=enc_n_points,
            dec_n_points=dec_n_points, num_queries=num_queries, num_points=num_points,
            voc_size=voc_size, temperature=temperature,
            in_channels=BACKBONE_CHANNELS["build_resnet_backbone"], boundary_head=boundary_head,
        )
        self.roi_heads = LSTMatcherHead(
            hidden_dim=hidden_dim, num_points=num_points, feature_dim=asso_feature_dim,
            num_fc=asso_num_fc, num_heads=asso_num_heads,
            num_encoder_layers=asso_num_encoder_layers,
            num_decoder_layers=asso_num_decoder_layers,
            num_weight_layers=asso_num_weight_layers, with_rescore=with_rescore,
        )

    def features(self, images: torch.Tensor):
        """NHWC normalized images -> (res3..5 NCHW features, NHWC position encodings)."""
        return backbone_features(self.backbone, images, self.hidden_dim, self.temperature)

    def spot(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Backbone + spotter (+ rescoring head) on un-padded NHWC frames."""
        feats, pos = self.features(images)
        out = self.detection_transformer(feats, pos, None)
        out["re_pred_logits"] = (
            self.roi_heads.rescore(out["query_features"]) if self.with_rescore else None
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

    def associate(self, reid_tokens, valid, short_term: bool):
        """Padded association transformer pass (LSTMatcherHead.associate)."""
        return self.roi_heads.associate(reid_tokens, valid, short_term)


class SpotterPretrainModel(nn.Module):
    """Image-spotter pretraining meta-arch (JAX ``SpotterPretrainModel``,
    gomatching_tpu/models/gomatching.py:271): backbone + DeepSolo spotter emitting the
    last-layer, aux-layer and encoder outputs ``SpotterCriterion`` reads; no tracker
    head, and the whole model trains, FrozenBN tensors included as in JAX. Inputs are
    square canvases with nothing padded, so there are no padding masks."""

    def __init__(self, resnet_depth=50, hidden_dim=256, n_heads=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=1024, num_feature_levels=4,
                 enc_n_points=4, dec_n_points=4, num_queries=100, num_points=25, voc_size=37,
                 temperature=10000.0, boundary_head=True):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.temperature = float(temperature)
        self.backbone = nn.Sequential(
            MaskedBackbone(ResNet(resnet_depth, ("res3", "res4", "res5")))
        )
        for mod in self.backbone.modules():
            if isinstance(mod, FrozenBN):
                mod.make_trainable_()
        self.detection_transformer = DeepSoloSpotter(
            d_model=hidden_dim, n_heads=n_heads, num_encoder_layers=num_encoder_layers,
            num_decoder_layers=num_decoder_layers, dim_feedforward=dim_feedforward,
            num_feature_levels=num_feature_levels, enc_n_points=enc_n_points,
            dec_n_points=dec_n_points, num_queries=num_queries, num_points=num_points,
            voc_size=voc_size, temperature=temperature,
            in_channels=BACKBONE_CHANNELS["build_resnet_backbone"], boundary_head=boundary_head,
        )

    def forward(self, images: torch.Tensor) -> Dict:
        """NHWC normalized images (B, H, W, 3) -> the spotter's training outputs."""
        feats, pos = backbone_features(self.backbone, images, self.hidden_dim, self.temperature)
        return self.detection_transformer(feats, pos, None, train_outputs=True)


def _check_ported(cfg) -> None:
    if cfg.MODEL.BACKBONE.NAME != "build_resnet_backbone":
        raise NotImplementedError(f"backbone {cfg.MODEL.BACKBONE.NAME} is not ported yet "
                                  "(ROADMAP A10)")
    if cfg.MODEL.PRECISION != "float32":
        raise NotImplementedError(f"MODEL.PRECISION={cfg.MODEL.PRECISION} is not ported yet")


def _spotter_kwargs(cfg) -> Dict:
    t = cfg.MODEL.TRANSFORMER
    return dict(
        resnet_depth=cfg.MODEL.RESNETS.DEPTH, hidden_dim=t.HIDDEN_DIM, n_heads=t.NHEADS,
        num_encoder_layers=t.ENC_LAYERS, num_decoder_layers=t.DEC_LAYERS,
        dim_feedforward=t.DIM_FEEDFORWARD, num_feature_levels=t.NUM_FEATURE_LEVELS,
        enc_n_points=t.ENC_N_POINTS, dec_n_points=t.DEC_N_POINTS, num_queries=t.NUM_QUERIES,
        num_points=t.NUM_POINTS, voc_size=t.VOC_SIZE, temperature=float(t.TEMPERATURE),
        boundary_head=t.BOUNDARY_HEAD,
    )


def build_pretrain_model(cfg) -> SpotterPretrainModel:
    """The spotter-pretraining model of a reference-schema config (ResNet only). The
    sampler is always the exact one (B1/B2 forwards, B3/B4 backwards on CUDA), so
    ``TPU.TRAIN_SAMPLING_IMPL`` is not read."""
    _check_ported(cfg)
    return SpotterPretrainModel(**_spotter_kwargs(cfg))


def build_model(cfg) -> GoMatchingModel:
    """Construct the meta-arch from a reference-schema config (ResNet, 'lst' only)."""
    _check_ported(cfg)
    if cfg.MODEL.ROI_HEADS.NAME != "LSTMatcher":
        raise NotImplementedError(f"ROI_HEADS.NAME={cfg.MODEL.ROI_HEADS.NAME} is not ported yet")
    if not cfg.MODEL.ASSO_HEAD.NO_POS_EMB:
        raise NotImplementedError("the positional-embedding matcher is not ported yet")
    t = cfg.MODEL.TRANSFORMER
    a = cfg.MODEL.ASSO_HEAD
    return GoMatchingModel(
        **_spotter_kwargs(cfg), asso_feature_dim=a.FC_DIM, asso_num_fc=a.NUM_FC,
        asso_num_heads=a.NUM_HEADS, asso_num_encoder_layers=a.NUM_ENCODER_LAYERS,
        asso_num_decoder_layers=a.NUM_DECODER_LAYERS,
        asso_num_weight_layers=a.NUM_WEIGHT_LAYERS, with_rescore=cfg.MODEL.ROI_HEADS.WITH_RESR,
        test_score_threshold=t.INFERENCE_TH_TEST, nms_thresh=cfg.VIDEO_TEST.NMS_THRESH,
    )
