"""Host-side JPEG decode behind a single API (PIL, or the native decoder on
request).

Own copy of the JAX package's ``data/jpeg.py`` without its TensorFlow
backend (golden tests only there). The decode is entropy-coded and
branch-heavy, the one stage of the input pipeline that stays on the host;
resize, augmentation and normalization run on the device
(``data.augment``). Records that carry a pre-decoded ``image/raw`` canvas
skip this module altogether (``data.pipeline.DetectionDataset``).

``decode_jpeg`` optionally resizes to a fixed host canvas so that batches
have static shapes before the transfer; normalized box coordinates are
resize-invariant, so labels need no adjustment.
"""

from __future__ import annotations

import io
from typing import Optional

import numpy as np


def decode_jpeg(
    data: bytes,
    canvas: Optional[int] = None,
    backend: str = "auto",
    draft: bool = False,
) -> np.ndarray:
    """JPEG bytes → RGB uint8 array ``[H, W, 3]`` (or ``[canvas, canvas, 3]``).

    backend:
      "auto"/"pil" — PIL (libjpeg-turbo), the production path; "auto"
        never switches implementation on what happens to be built.
      "native" — explicit opt-in to the C++ decoder (``data._native``:
        DCT-scaled decode + plain bilinear canvas resize, not PIL's; built
        at first use, raises without libjpeg's headers).

    draft: with a ``canvas``, enable libjpeg DCT-scaled decode (PIL draft
      mode): the image is decoded at the nearest ≥canvas power-of-two
      fraction, then bilinear-resized to the canvas. Pixels differ slightly
      from the full decode, so this is a training input option.
    """
    if backend == "native":
        from multibox_tpu_torch.data import _native

        return _native.decode_jpeg(data, canvas)
    if backend not in ("auto", "pil"):
        raise ValueError(f"unknown JPEG backend: {backend!r}")
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    if draft and canvas is not None:
        img.draft("RGB", (canvas, canvas))
    img = img.convert("RGB")
    if canvas is not None:
        img = img.resize((canvas, canvas), Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8)


def encode_jpeg(image: np.ndarray, quality: int = 95) -> bytes:
    """RGB uint8 array → JPEG bytes (fixtures, dataset builders)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _resize_np(img: np.ndarray, canvas: int) -> np.ndarray:
    from PIL import Image

    return np.asarray(
        Image.fromarray(img).resize((canvas, canvas), Image.BILINEAR),
        dtype=np.uint8,
    )
