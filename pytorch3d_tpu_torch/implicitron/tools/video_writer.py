"""Write image sequences to video (port of
pytorch3d_tpu/implicitron/tools/video_writer.py): through ffmpeg for an
.mp4 path when ffmpeg is on the PATH, else as an animated GIF through
PIL."""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

import numpy as np


class VideoWriter:
    def __init__(self, fps: int = 20, out_path: str = os.path.join(tempfile.gettempdir(), "video.mp4")) -> None:
        self.fps = fps
        self.out_path = out_path
        self.frames = []

    def write_frame(self, frame, resize=None) -> None:
        """frame: (H, W, 3) float in [0, 1] or uint8, an array or a tensor."""
        if hasattr(frame, "detach"):
            frame = frame.detach().cpu().numpy()
        arr = np.asarray(frame)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
        if resize is not None:
            from PIL import Image

            arr = np.asarray(Image.fromarray(arr).resize((resize[1], resize[0])))
        self.frames.append(arr)

    def get_video(self, quiet: bool = True) -> str:
        """Write the frames; returns the path written (the .gif beside
        `out_path` where the GIF route ran)."""
        if not self.frames:
            raise ValueError("No frames written")
        from PIL import Image

        if shutil.which("ffmpeg") and self.out_path.endswith(".mp4"):
            with tempfile.TemporaryDirectory("video_writer") as frame_dir:
                for i, f in enumerate(self.frames):
                    Image.fromarray(f).save(os.path.join(frame_dir, "frame_%06d.png" % i))
                cmd = [
                    "ffmpeg", "-y", "-framerate", str(self.fps),
                    "-i", os.path.join(frame_dir, "frame_%06d.png"),
                    "-pix_fmt", "yuv420p", self.out_path,
                ]
                subprocess.run(
                    cmd, check=True,
                    stdout=subprocess.DEVNULL if quiet else None, stderr=subprocess.DEVNULL if quiet else None,
                )
        else:
            out = self.out_path if self.out_path.endswith(".gif") else self.out_path.rsplit(".", 1)[0] + ".gif"
            imgs = [Image.fromarray(f) for f in self.frames]
            imgs[0].save(out, save_all=True, append_images=imgs[1:], duration=int(1000 / self.fps), loop=0)
            self.out_path = out
        return self.out_path
