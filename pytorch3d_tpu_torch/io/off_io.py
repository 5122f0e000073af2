"""OFF / COFF mesh files (port of pytorch3d_tpu/io/off_io.py): OFF and
COFF headers (also on the counts' line), vertex colours as 6 or 7 columns
(integer 0-255 or float 0-1), face colours as 3 or 4 trailing columns tiled
over each face's fan; `save_off` writes COFF when given vertex colours.
Host parsing; tensors made once at the end.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .utils import _device, _to_numpy


def _tokens_have_period(tokens) -> bool:
    return any("." in t or "e" in t or "E" in t for t in tokens)


def load_off_full(f, device=None) -> Dict[str, torch.Tensor]:
    """Load an OFF/COFF file into a dict with `verts`, `faces` and, when
    present, `verts_colors` (V, 3|4) and `faces_colors` (F, 3|4) in [0, 1]
    (integer 0-255 colours are rescaled), float32 / int32 tensors on
    `device` (None: the card)."""
    device = _device(device)
    if hasattr(f, "read"):
        text = f.read()
        if isinstance(text, bytes):
            text = text.decode("ascii")
    else:
        with open(str(f), "r") as fh:
            text = fh.read()
    lines = [ln.split("#")[0].strip() for ln in text.splitlines()]
    lines = [ln for ln in lines if ln]
    if not lines:
        raise ValueError("Not enough data in OFF file.")
    first = lines[0]
    up = first.upper()
    for kw in ("CNOFF", "COFF", "NOFF", "OFF"):
        if up.startswith(kw):
            rest = first[len(kw):].strip()
            lines = ([rest] if rest else []) + lines[1:]
            break
    if not lines:
        raise ValueError("Not enough data in OFF file.")
    counts = lines[0].split()
    nv, nf = int(counts[0]), int(counts[1])
    if len(lines) < 1 + nv:
        raise ValueError("Not enough vertex data.")

    # vertices are consumed (and validated) before the face-count check,
    # like the reference loader — a wrong nv surfaces as a column error
    vert_rows = [ln.split() for ln in lines[1 : 1 + nv]]
    ncols = len(vert_rows[0])
    if any(len(r) != ncols for r in vert_rows):
        raise ValueError(
            "Inconsistent number of columns in OFF vertex rows."
        )
    if ncols not in (3, 6, 7):
        raise ValueError(f"Bad number of columns in vertex data ({ncols}).")

    if len(lines) < 1 + nv + nf:
        raise ValueError("Not enough face data.")
    if len(lines) > 1 + nv + nf:
        raise ValueError(
            f"Extra data at end of file: {lines[1 + nv + nf]}"
        )
    vdata = np.asarray([[float(x) for x in r] for r in vert_rows], np.float32)
    verts = vdata[:, :3]
    verts_colors = None
    if ncols > 3:
        # integer 0-255 colors have no decimal point (reference
        # _count_next_line_periods heuristic)
        scale = 1.0 if _tokens_have_period(vert_rows[0][3:]) else 1 / 255.0
        verts_colors = vdata[:, 3:] * scale

    faces = []
    face_colors = []
    n_colors: Optional[int] = None
    for ln in lines[1 + nv : 1 + nv + nf]:
        tokens = ln.split()
        n = int(tokens[0])
        if n < 3:
            raise ValueError("Faces must have at least 3 vertices.")
        if len(tokens) < 1 + n:
            raise ValueError(
                "A line of face data did not have the specified length."
            )
        poly = [int(t) for t in tokens[1 : 1 + n]]
        ctoks = tokens[1 + n :]
        if n_colors is None:
            n_colors = len(ctoks)
            if n_colors not in (0, 3, 4):
                raise ValueError("Unexpected number of face colors.")
            cscale = (
                1.0 if _tokens_have_period(ctoks) else 1 / 255.0
            ) if n_colors else 1.0
        elif len(ctoks) != n_colors:
            raise ValueError("Number of colors differs between faces.")
        col = [float(c) * cscale for c in ctoks]
        for k in range(n - 2):
            faces.append((poly[0], poly[k + 1], poly[k + 2]))
            if n_colors:
                face_colors.append(col)

    out = {
        "verts": torch.as_tensor(verts, device=device),
        "faces": torch.as_tensor(np.asarray(faces, np.int32).reshape(-1, 3), device=device),
    }
    if verts_colors is not None:
        out["verts_colors"] = torch.as_tensor(verts_colors, device=device)
    if face_colors:
        out["faces_colors"] = torch.as_tensor(np.asarray(face_colors, np.float32), device=device)
    return out


def load_off(f, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Load an OFF file: (verts (V, 3), faces (F, 3) fan-triangulated) on
    `device` (None: the card)."""
    data = load_off_full(f, device=device)
    return data["verts"], data["faces"]


def save_off(f, verts, faces, verts_colors=None, faces_colors=None) -> None:
    """Write OFF (or COFF when `verts_colors` is given); colors written as
    floats in [0, 1]."""
    verts = _to_numpy(verts)
    faces = _to_numpy(faces)
    vcol = None if verts_colors is None else _to_numpy(verts_colors)
    fcol = None if faces_colors is None else _to_numpy(faces_colors)

    own = not hasattr(f, "write")
    fh = open(str(f), "w") if own else f
    try:
        fh.write("COFF\n" if vcol is not None else "OFF\n")
        fh.write(f"{verts.shape[0]} {faces.shape[0]} 0\n")
        for i, v in enumerate(verts):
            row = " ".join(f"{x:.6f}" for x in v)
            if vcol is not None:
                row += " " + " ".join(f"{c:.6f}" for c in vcol[i])
            fh.write(row + "\n")
        for i, face in enumerate(faces):
            row = "3 " + " ".join(str(int(x)) for x in face)
            if fcol is not None:
                row += " " + " ".join(f"{c:.6f}" for c in fcol[i])
            fh.write(row + "\n")
    finally:
        if own:
            fh.close()
