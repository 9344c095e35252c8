"""Queue-based encoder API.

Reference: lib/jxl/encode.cc (JxlEncoder: frame settings, AddImageFrame /
AddBox queue, ProcessOutput), include/jxl/encode.h
JxlEncoderFrameSettingId (the full id 0..40 surface of the reference
snapshot, include/jxl/encode.h:132-418) and include/jxl/stats.h
(JxlEncoderStats). Frames and metadata boxes are queued, then the whole
container/codestream is produced by process_output().

Copy of libjxl_tpu/api/encoder.py. One difference (reference line
numbers): ``Encoder`` takes ``device`` (new argument, default ``cuda``),
the torch device on which ``process_output`` runs the port's ``encode``
of a single frame (:189-199). Animations go through ``encode_animation``
on the host, as in the reference.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


class FrameSettingId(enum.IntEnum):
    """JxlEncoderFrameSettingId (include/jxl/encode.h:1312)."""
    EFFORT = 0
    DECODING_SPEED = 1
    RESAMPLING = 2
    EXTRA_CHANNEL_RESAMPLING = 3
    ALREADY_DOWNSAMPLED = 4
    PHOTON_NOISE = 5
    NOISE = 6
    DOTS = 7
    PATCHES = 8
    EPF = 9
    GABORISH = 10
    MODULAR = 11
    KEEP_INVISIBLE = 12
    GROUP_ORDER = 13
    GROUP_ORDER_CENTER_X = 14
    GROUP_ORDER_CENTER_Y = 15
    RESPONSIVE = 16
    PROGRESSIVE_AC = 17
    QPROGRESSIVE_AC = 18
    PROGRESSIVE_DC = 19
    CHANNEL_COLORS_GLOBAL_PERCENT = 20
    CHANNEL_COLORS_GROUP_PERCENT = 21
    PALETTE_COLORS = 22
    LOSSY_PALETTE = 23
    COLOR_TRANSFORM = 24
    MODULAR_COLOR_SPACE = 25
    MODULAR_GROUP_SIZE = 26
    MODULAR_PREDICTOR = 27
    MODULAR_MA_TREE_LEARNING_PERCENT = 28
    MODULAR_NB_PREV_CHANNELS = 29
    JPEG_RECON_CFL = 30
    INDEX_BOX = 31
    BROTLI_EFFORT = 32
    JPEG_COMPRESS_BOXES = 33
    BUFFERING = 34
    JPEG_KEEP_EXIF = 35
    JPEG_KEEP_XMP = 36
    JPEG_KEEP_JUMBF = 37
    USE_FULL_IMAGE_HEURISTICS = 38
    DISABLE_PERCEPTUAL_HEURISTICS = 39
    OUTPUT_MODE = 40


# Options this encoder maps onto real knobs; everything else is
# accepted (validated range) and recorded, mirroring the C API which
# accepts all ids on every backend. -1 always means "encoder default".
_RANGES = {
    FrameSettingId.EFFORT: (1, 10),
    FrameSettingId.DECODING_SPEED: (0, 4),
    FrameSettingId.RESAMPLING: (-1, 8),
    FrameSettingId.EXTRA_CHANNEL_RESAMPLING: (-1, 8),
    FrameSettingId.PHOTON_NOISE: (0, 1 << 20),
    FrameSettingId.EPF: (-1, 3),
    FrameSettingId.PALETTE_COLORS: (-1, 1 << 16),
    FrameSettingId.MODULAR_GROUP_SIZE: (-1, 3),
    FrameSettingId.MODULAR_PREDICTOR: (-1, 15),
    FrameSettingId.BROTLI_EFFORT: (-1, 11),
    FrameSettingId.BUFFERING: (-1, 3),
    FrameSettingId.OUTPUT_MODE: (-1, 1),
}


@dataclasses.dataclass
class FrameSettings:
    """JxlEncoderFrameSettings analogue."""
    distance: float = 1.0
    lossless: bool = False
    effort: int = 7
    progressive: bool = False
    resampling: int = 1
    noise: float | None = None
    duration: int = 0
    photon_noise_iso: float | None = None
    dots: bool = False
    patches: bool = True
    modular: bool = False
    options: dict = dataclasses.field(default_factory=dict)

    def set_option(self, option, value) -> None:
        """JxlEncoderFrameSettingsSetOption: validates and applies."""
        option = FrameSettingId(option)
        lo, hi = _RANGES.get(option, (-(1 << 30), 1 << 30))
        if not (lo <= value <= hi):
            raise ValueError(f"{option.name} value {value} out of range")
        if option == FrameSettingId.EFFORT:
            self.effort = int(value)
        elif option == FrameSettingId.RESAMPLING:
            self.resampling = max(1, int(value))
        elif option == FrameSettingId.PHOTON_NOISE:
            self.photon_noise_iso = float(value) or None
        elif option == FrameSettingId.NOISE:
            self.noise = None if value == -1 else \
                ("auto" if value == 1 else None)
        elif option == FrameSettingId.DOTS:
            self.dots = value == 1
        elif option == FrameSettingId.PATCHES:
            self.patches = value != 0
        elif option == FrameSettingId.MODULAR:
            self.modular = value == 1
        elif option in (FrameSettingId.PROGRESSIVE_AC,
                        FrameSettingId.QPROGRESSIVE_AC):
            self.progressive = value == 1
        else:
            self.options[option] = value

    def set_distance(self, distance: float) -> None:
        if not (0.0 <= distance <= 25.0):
            raise ValueError("distance out of range")
        self.distance = distance
        self.lossless = distance == 0.0


class Encoder:
    """JxlEncoder analogue. Usage:

        enc = Encoder(use_container=True)
        enc.add_image_frame(img, FrameSettings(distance=1.0))
        data = enc.process_output()

    device: the torch device of a single frame's encode (default
    ``cuda``; raises when there is no card).
    """

    def __init__(self, *, use_container: bool = False,
                 animation_tps: tuple | None = None, num_loops: int = 0,
                 collect_stats: bool = False, device=None):
        self.device = device
        self._frames: list = []
        self._boxes: list = []
        self.use_container = use_container
        self.animation_tps = animation_tps
        self.num_loops = num_loops
        self._output: bytes | None = None
        self._stats = None
        if collect_stats:
            from libjxl_tpu_torch.frame.aux_out import AuxOut
            self._stats = AuxOut()

    def frame_settings(self) -> FrameSettings:
        """JxlEncoderFrameSettingsCreate."""
        return FrameSettings()

    def add_image_frame(self, image: np.ndarray,
                        settings: FrameSettings | None = None) -> None:
        if self._output is not None:
            raise RuntimeError("encoder output already produced")
        self._frames.append((image, settings or FrameSettings()))

    def add_box(self, box_type: bytes, contents: bytes) -> None:
        if box_type not in (b"Exif", b"xml ", b"jumb"):
            raise ValueError(f"unsupported box type {box_type!r}")
        self._boxes.append((box_type, contents))
        self.use_container = True

    def stats(self) -> dict:
        """JxlEncoderStatsGet analogue: per-layer bit accounting
        (enc_aux_out.h AuxOut) for the frames encoded so far."""
        if self._stats is None:
            raise RuntimeError("encoder created without collect_stats")
        pixels = sum(f[0].shape[0] * f[0].shape[1] for f in self._frames)
        return self._stats.summary(pixels or None)

    def process_output(self) -> bytes:
        from libjxl_tpu_torch.api.simple import encode, encode_animation
        from libjxl_tpu_torch.container.boxes import pack_container

        if self._output is not None:
            return self._output
        if not self._frames:
            raise RuntimeError("no frames queued")
        if len(self._frames) == 1 and self.animation_tps is None:
            img, s = self._frames[0]
            codestream = encode(img, distance=s.distance,
                                lossless=s.lossless,
                                progressive=s.progressive,
                                noise=s.noise, resampling=s.resampling,
                                effort=s.effort, dots=s.dots,
                                patches=s.patches, modular=s.modular,
                                photon_noise_iso=s.photon_noise_iso,
                                epf=int(s.options.get(
                                    FrameSettingId.EPF, -1)),
                                aux_out=self._stats, device=self.device)
        else:
            imgs = [f[0] for f in self._frames]
            settings = self._frames[0][1]
            durations = [f[1].duration or 1 for f in self._frames]
            codestream = encode_animation(
                imgs, durations=durations,
                tps=self.animation_tps or (10, 1),
                distance=settings.distance, lossless=settings.lossless,
                num_loops=self.num_loops)
        if self.use_container or self._boxes:
            exif = None
            xml = []
            for (btype, contents) in self._boxes:
                if btype == b"Exif":
                    exif = contents
                elif btype == b"xml ":
                    xml.append(contents)
            self._output = pack_container(codestream, exif=exif, xml=xml)
        else:
            self._output = codestream
        return self._output
