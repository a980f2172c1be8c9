"""Video inference driver of the PyTorch port: spot + track every video under
--input and emit ICDAR-protocol XML/JSON per video plus per-track transcriptions.

    python -m gomatching_tpu_torch.eval --config-file configs/GoMatching_ICDAR15.yaml \\
        --input <videos_dir> --output <out_dir> [--cpu] [--opts KEY VALUE ...]

Same flags and output tree as the repository's root ``eval.py`` (reference eval.py):
<output>/preds/res_*.xml, <output>/jsons/*.json, <output>/preds/res_*.txt. Runs on the
current CUDA device; ``--cpu`` runs on the CPU. ``MODEL.WEIGHTS`` names the JAX
package's ``.npz`` params or a torch checkpoint, or is '' for seeded random weights.
Frames are decoded on a background thread (``utils.prefetch``), except under ``--show``,
which keeps every frame and draws the tracks into <output>/vis/<video>/<n>.jpg.
``--profile-dir`` writes a ``torch.profiler`` Chrome trace there.
"""

from __future__ import annotations

import argparse
import os
import time
from glob import glob


def get_parser():
    p = argparse.ArgumentParser(description="GoMatching video text spotting eval (PyTorch)")
    p.add_argument("--config-file", metavar="FILE", required=True)
    p.add_argument("--cpu", action="store_true", help="Run on the CPU")
    p.add_argument("--input", nargs="+", help="Directory of video frame dirs")
    p.add_argument("--output", required=True)
    p.add_argument("--show", action="store_true", help="Save visualizations")
    p.add_argument("--profile-dir", default="",
                   help="Write a torch.profiler Chrome trace into this directory")
    p.add_argument("--opts", default=[], nargs=argparse.REMAINDER)
    return p


def list_videos(videos_dir: str):
    """(data_type, sorted frame-directory paths), the reference's dataset layout."""
    if "DSText" in videos_dir:
        data_type = "DSText"
    elif "ICDAR15" in videos_dir:
        data_type = "ICDAR15"
    elif "BOVText" in videos_dir:
        data_type = "BOVText"
    else:
        data_type = "OTHER"
    video_files = []
    for v in sorted(os.listdir(videos_dir)):
        if data_type in ("DSText", "BOVText"):
            for vf in sorted(os.listdir(os.path.join(videos_dir, v))):
                video_files.append(os.path.join(videos_dir, v, vf))
        else:
            video_files.append(os.path.join(videos_dir, v))
    return data_type, video_files


def annotate(predictor, tracked):
    """Tracked frames -> {frame id: [x1..y4, id, text, seg]} lines."""
    from .evaluation.writer import boundary_to_polygon, frame_lines

    annotation = {}
    for frame_id, det in enumerate(tracked):
        polys = [boundary_to_polygon(bd) for bd in det.bd]
        texts = [predictor.decode_text(r) for r in det.recs]
        annotation[str(frame_id + 1)] = frame_lines(polys, det.track_ids, texts)
    return annotation


def main(argv=None):
    """Run the CLI; returns the predictor, the ``time_cost`` buckets and each processed
    video's (frames, seconds)."""
    args = get_parser().parse_args(argv)

    import cv2

    from .config import setup_eval_cfg
    from .engine.predictor import VideoPredictor
    from .evaluation.visualizer import save_tracked_video_frames
    from .evaluation.writer import write_track_transcriptions, write_video_results
    from .utils.prefetch import prefetch_iter
    from .utils.profiling import device_trace, fps_report, new_time_cost

    cfg = setup_eval_cfg(args.config_file, args.opts)
    xml_dir = os.path.join(args.output, "preds")
    json_dir = os.path.join(args.output, "jsons")
    for d in (xml_dir, json_dir, os.path.join(args.output, "results")):
        os.makedirs(d, exist_ok=True)
    preded = {
        os.path.basename(p).split("res_")[-1].split(".xml")[0] for p in glob(xml_dir + "/*.xml")
    }
    if not args.input or not os.path.isdir(args.input[0]):
        raise SystemExit(f"--input must name a directory of videos, got {args.input}")
    data_type, video_files = list_videos(args.input[0])

    predictor = VideoPredictor(cfg, device="cpu" if args.cpu else None)
    time_cost = new_time_cost()
    total_frames = 0
    videos = {}
    with device_trace(args.profile_dir):
        for video in video_files:
            video_name = os.path.basename(video).split(".")[0]
            if video_name == "Cls1_Livestreaming_video40" or video_name in preded:
                continue
            img_paths = sorted(
                (os.path.join(video, f) for f in os.listdir(video)),
                key=lambda x: int(os.path.basename(x).split(".")[0]),
            )
            n_frames = len(img_paths)
            # --show keeps the eager list: the visualizer needs every frame afterwards;
            # otherwise a background thread decodes ahead of the consumer, at most 128
            # frames (JAX eval.py:113-125)
            if args.show:
                frames = [cv2.imread(p) for p in img_paths]
            else:
                frames = prefetch_iter((cv2.imread(p) for p in img_paths), 128)
            print(f"processing {video_name}... ({n_frames} frames)")
            t0 = time.time()
            tracked = predictor.process_video(frames, time_cost)
            elapsed = time.time() - t0
            time_cost["total_time"] += elapsed
            total_frames += n_frames
            videos[video_name] = (n_frames, elapsed)
            if data_type == "ICDAR15":
                parts = video_name.split("_")
                xml_name = (parts[0] + "_" + parts[1]).replace("V", "v")
            else:
                xml_name = video_name
            write_video_results(
                annotate(predictor, tracked),
                os.path.join(json_dir, f"{video_name}.json"),
                os.path.join(xml_dir, f"res_{xml_name}.xml"),
            )
            if args.show:
                save_tracked_video_frames(frames, tracked,
                                          os.path.join(args.output, "vis", video_name),
                                          decode_text=predictor.decode_text)
            print(f"Video: {video_name} per_img_time: {elapsed / max(n_frames, 1):.4f} "
                  f"FPS: {n_frames / max(elapsed, 1e-9):.2f}")
    write_track_transcriptions(xml_dir)
    if time_cost["total_time"] > 0:
        print(fps_report(time_cost, total_frames))
    # backbone and rescore run inside the detector's one spot call, as in JAX's eval.py
    print(time_cost, "(backbone+rescore fused into detector)")
    return {"predictor": predictor, "time_cost": time_cost, "videos": videos}


if __name__ == "__main__":
    main()
