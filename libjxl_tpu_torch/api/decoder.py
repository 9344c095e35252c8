"""Event-driven streaming decoder API with section-granular resume.

Reference: lib/jxl/decode.cc (JxlDecoder: Subscribe/SetInput/
ProcessInput event loop with BASIC_INFO, COLOR_ENCODING, FRAME,
FRAME_PROGRESSION, FULL_IMAGE, SUCCESS, NEED_MORE_INPUT; rewind/skip
decode.h:392-412; flush decode.h:1452).

Input may arrive byte-by-byte. VarDCT frames decode incrementally —
each bitstream section is decoded exactly once when its bytes complete
(O(n) total work, dec_frame.cc:571-735), and ``flush_image()`` renders
the best partial image from the passes received. Frames outside the
incremental profile (modular, subsampled, DC-frame users) fall back to
one-shot decoding when their bytes are complete.

Copy of libjxl_tpu/api/decoder.py with imports rewritten to the port.
A host entry point, as ``decode_low_memory`` is: the one-shot frame step
(``_try_frame_oneshot``) calls ``decode_frame`` with no device, the
port's host route, as the reference does; the preview decode and the
incremental path (``frame/incremental.py``) are host code; and
``_to_pixels`` takes the native fused sRGB tail, so that its pixels are
the host one-shot decoder's. It takes no ``device`` argument: decoding
its frames on the card would be a feature the JAX package lacks.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from libjxl_tpu_torch.base.errors import JxlError
from libjxl_tpu_torch.bitstream.bit_io import BitReader


class Event(enum.IntEnum):
    NEED_MORE_INPUT = 0
    BASIC_INFO = 1
    COLOR_ENCODING = 2
    FRAME = 3
    FULL_IMAGE = 4
    SUCCESS = 5
    ERROR = 6
    FRAME_PROGRESSION = 7
    BOX = 8                     # JXL_DEC_BOX
    JPEG_RECONSTRUCTION = 9     # JXL_DEC_JPEG_RECONSTRUCTION


@dataclasses.dataclass
class BasicInfo:
    xsize: int
    ysize: int
    bits_per_sample: int
    uses_original_profile: bool
    have_animation: bool
    num_extra_channels: int
    alpha_bits: int
    orientation: int


class Decoder:
    """JxlDecoder analogue. Usage:

        dec = Decoder(events={Event.BASIC_INFO, Event.FULL_IMAGE})
        dec.set_input(chunk); status = dec.process_input()

    ``flush_image()`` returns the best partial image mid-frame;
    ``rewind()`` / ``skip_frames(n)`` mirror JxlDecoderRewind/SkipFrames.
    """

    def __init__(self, events=None):
        self._events = set(events) if events else {
            Event.BASIC_INFO, Event.COLOR_ENCODING, Event.FRAME,
            Event.FULL_IMAGE}
        self._data = b""
        self._input_closed = False
        self._stage = 0          # 0=headers, 1=frames, 2=done
        self.basic_info: BasicInfo | None = None
        self.color_encoding = None
        self.metadata = None
        self.frame_header = None
        self.image: np.ndarray | None = None
        self.frames: list = []
        self._codestream: bytes | None = None
        self._frame_bitpos = 0
        self._refs: list = [None] * 4
        self._dcs: list = [None] * 5
        self._preview_done = False
        self._pending: list = []
        self._inc = None                 # IncrementalFrameDecoder
        self._inc_unsupported = False
        self._frame_starts: list = []    # bit positions of decoded frames
        self._skip = 0
        self._progress_groups = 0
        self.box_type: bytes | None = None
        self.box_contents: bytes | None = None
        self.jpeg_bytes: bytes | None = None
        self._boxes_pending: list | None = None
        self._jbrd_seen = False
        self._preferred_profile = None   # "srgb" | "linear" | ICC bytes
        self._image_out_cb = None

    def set_input(self, data: bytes) -> None:
        self._data += data

    def close_input(self) -> None:
        self._input_closed = True

    # -- rewind / skip ----------------------------------------------------

    def rewind(self) -> None:
        """Restart frame iteration from the first frame; parsed headers
        and accumulated input are kept (JxlDecoderRewind)."""
        self._stage = 1 if self.metadata is not None else 0
        self._frame_bitpos = self._headers_end_bit \
            if self.metadata is not None else 0
        self._refs = [None] * 4
        self._dcs = [None] * 5
        self._preview_done = False
        self._inc = None
        self._inc_unsupported = False
        self.frames = []
        self._pending = []
        self._skip = 0

    def skip_frames(self, n: int) -> None:
        """Skip decoding of the next n visible frames
        (JxlDecoderSkipFrames); their sections are skipped via the TOC,
        not decoded."""
        self._skip += n

    def set_preferred_color_profile(self, profile) -> None:
        """JxlDecoderSetPreferredColorProfile (decode.h:1021): request
        the output color space. Accepts "srgb" (default), "linear"
        (linear sRGB primaries) or an ICC profile (bytes) applied with
        the lcms2-backed CMS. Must be called before the frame decodes.
        """
        if profile not in ("srgb", "linear") \
                and not isinstance(profile, (bytes, bytearray)):
            raise ValueError("profile must be 'srgb', 'linear' or ICC "
                             "bytes")
        self._preferred_profile = profile

    def set_image_out_callback(self, fn) -> None:
        """JxlDecoderSetImageOutCallback (decode.h:1152): fn(x, y,
        num_pixels, row_pixels) is invoked once per output row when a
        frame completes, instead of requiring the full-image buffer.
        row_pixels is the (num_pixels, C) slice of that row."""
        if not callable(fn):
            raise ValueError("callback must be callable")
        self._image_out_cb = fn

    def _deliver_rows(self, arr: np.ndarray) -> None:
        if self._image_out_cb is None:
            return
        for y in range(arr.shape[0]):
            self._image_out_cb(0, y, arr.shape[1], arr[y])

    def flush_image(self) -> np.ndarray | None:
        """Best partial image of the in-progress frame
        (JxlDecoderFlushImage), or None when too little has arrived."""
        if self._inc is None or not self._inc.can_flush:
            return None
        xyb = self._inc.flush()
        if xyb is None:
            return None
        return self._to_pixels(xyb)

    # -- internals ---------------------------------------------------------

    def _resolve_codestream(self) -> bool:
        from libjxl_tpu_torch.container.boxes import (
            is_container, unpack_container)
        if len(self._data) < 12 and is_container(self._data):
            if self._data[:2] != b"\xff\x0a":
                return False
        if len(self._data) >= 12 and is_container(self._data):
            try:
                content = unpack_container(self._data)
                self._codestream = content.codestream
                if self._boxes_pending is None:
                    boxes = []
                    if Event.BOX in self._events:
                        if content.exif:
                            boxes.append((b"Exif", content.exif))
                        for x in getattr(content, "xml", []) or []:
                            boxes.append((b"xml ", x))
                    self._boxes_pending = boxes
                    if content.jpeg_reconstruction:
                        self._jbrd_seen = True
                return True
            except JxlError:
                if self._input_closed:
                    raise
                return False
        self._codestream = self._data
        if self._boxes_pending is None:
            self._boxes_pending = []
        return True

    def _try_headers(self) -> bool:
        from libjxl_tpu_torch.frame.headers import read_codestream_headers
        try:
            r = BitReader(self._codestream)
            meta = read_codestream_headers(r)
        except JxlError:
            if self._input_closed:
                raise
            return False
        self.metadata = meta
        m = meta.m
        alpha_bits = 0
        for eci in m.extra_channel_info:
            if eci.type == 1:
                alpha_bits = eci.bit_depth.bits_per_sample
        self.basic_info = BasicInfo(
            xsize=meta.xsize, ysize=meta.ysize,
            bits_per_sample=m.bit_depth.bits_per_sample,
            uses_original_profile=not m.xyb_encoded,
            have_animation=m.have_animation,
            num_extra_channels=m.num_extra_channels,
            alpha_bits=alpha_bits, orientation=m.orientation)
        self.color_encoding = m.color_encoding
        self._frame_bitpos = r.bits_consumed
        self._headers_end_bit = r.bits_consumed
        return True

    def _to_pixels(self, xyb: np.ndarray) -> np.ndarray:
        from libjxl_tpu_torch.color.xyb import (
            linear_to_srgb, xyb_to_linear_rgb, xyb_to_srgb_px_native)
        bits = self.metadata.m.bit_depth.bits_per_sample
        dtype = np.uint8 if bits <= 8 else np.uint16
        maxval = (1 << bits) - 1
        pref = self._preferred_profile
        if pref is None or pref == "srgb":
            # Same fused native tail as api.simple.decode, so the
            # streaming decoder's pixels are bit-identical to the
            # one-shot decoder's.
            fused = xyb_to_srgb_px_native(xyb, maxval, dtype)
            if fused is not None:
                return fused
        linear = xyb_to_linear_rgb(xyb)
        if pref == "linear":
            arr = np.clip(np.round(linear * maxval), 0, maxval)
            return arr.astype(dtype).transpose(1, 2, 0)
        srgb = linear_to_srgb(linear)
        if isinstance(pref, (bytes, bytearray)):
            from libjxl_tpu_torch.color.cms import convert_pixels, srgb_icc
            out = convert_pixels(
                np.ascontiguousarray(
                    srgb.transpose(1, 2, 0).astype(np.float32)),
                srgb_icc(), bytes(pref))
            arr = np.clip(np.round(out * maxval), 0, maxval)
            return arr.astype(dtype)
        arr = np.clip(np.round(srgb * maxval), 0, maxval).astype(dtype)
        return arr.transpose(1, 2, 0)

    def _frame_done(self, xyb, fh, extra=None) -> None:
        self.frame_header = fh
        bits = self.metadata.m.bit_depth.bits_per_sample
        dtype = np.uint8 if bits <= 8 else np.uint16
        maxval = (1 << bits) - 1
        arr = self._to_pixels(xyb)
        if extra:
            alpha = np.clip(extra[0], 0, maxval).astype(dtype)[:, :, None]
            arr = np.concatenate([arr, alpha], axis=-1)
        self.image = arr
        self.frames.append(arr)
        self._deliver_rows(arr)

    def _try_frame_oneshot(self) -> bool:
        """Fallback: decode the next frame whole (restart when more
        bytes arrive) — used for frame types outside the incremental
        profile."""
        from libjxl_tpu_torch.frame.decode_frame import decode_frame
        from libjxl_tpu_torch.frame.frame_header import FrameType
        try:
            r = BitReader(self._codestream)
            r.seek_bits(self._frame_bitpos)
            frame = decode_frame(r, self.metadata, self._refs,
                                 dc_frames=self._dcs)
        except JxlError:
            if self._input_closed:
                raise
            return False
        self._frame_bitpos = r.bits_consumed
        fh = frame.header
        if fh.frame_type == FrameType.DC_FRAME:
            self._dcs[fh.dc_level] = frame.xyb
            return self._try_frame_oneshot()
        if fh.frame_type == FrameType.REFERENCE_ONLY:
            if frame.xyb is not None:
                self._refs[fh.save_as_reference] = frame.xyb
            return self._try_frame_oneshot()
        bits = self.metadata.m.bit_depth.bits_per_sample
        dtype = np.uint8 if bits <= 8 else np.uint16
        maxval = (1 << bits) - 1
        if self._skip > 0:
            # JxlDecoderSkipFrames: drop this visible frame.
            self._skip -= 1
            return self._try_frame_oneshot()
        if frame.modular_channels is not None:
            arr = np.stack(frame.modular_channels, axis=-1)
            self.image = np.clip(arr, 0, maxval).astype(dtype)
            self.frames.append(self.image)
            self.frame_header = fh
        else:
            self._frame_done(frame.xyb, fh, frame.extra_channels)
        self._is_last = fh.is_last
        return True

    def _advance_frame(self) -> Event | None:
        """Incremental path; returns an Event to surface or None when
        more input is needed."""
        from libjxl_tpu_torch.frame.incremental import (
            IncrementalFrameDecoder, NotSupported)

        if self._preview_done is False and self.metadata.m.have_preview:
            # Previews are small: decode one-shot.
            from libjxl_tpu_torch.frame.decode_frame import decode_frame
            try:
                r = BitReader(self._codestream)
                r.seek_bits(self._frame_bitpos)
                decode_frame(r, self.metadata, self._refs, is_preview=True)
            except JxlError:
                if self._input_closed:
                    raise
                return None
            self._preview_done = True
            self._frame_bitpos = r.bits_consumed

        if self._inc_unsupported:
            if not self._try_frame_oneshot():
                return None
            if Event.FRAME in self._events:
                self._pending.append(Event.FRAME)
            return Event.FULL_IMAGE

        if self._inc is None:
            inc = IncrementalFrameDecoder(self.metadata)
            try:
                if not inc.init(self._codestream, self._frame_bitpos):
                    if self._input_closed:
                        raise JxlError("truncated frame header")
                    return None
            except NotSupported:
                self._inc_unsupported = True
                return self._advance_frame()
            inc.reference_frames = self._refs
            self._inc = inc
            if Event.FRAME in self._events:
                self._pending.append(Event.FRAME)
            self._progress_groups = 0

        inc = self._inc
        from libjxl_tpu_torch.frame.frame_header import FrameType
        if self._skip > 0 and inc.fh.frame_type == FrameType.REGULAR:
            # Skip: jump over the frame's sections via the TOC.
            if len(self._codestream) < inc.frame_end_byte:
                return None
            self._frame_bitpos = inc.frame_end_byte * 8
            self._skip -= 1
            self._inc = None
            return self._advance_frame()

        new = inc.process_available(self._codestream)
        if new and Event.FRAME_PROGRESSION in self._events \
                and inc.can_flush:
            self._pending.append(Event.FRAME_PROGRESSION)
        if not inc.complete:
            if self._input_closed and \
                    len(self._codestream) >= inc.frame_end_byte:
                raise JxlError("frame sections failed to decode")
            return None
        fh = inc.fh
        if inc.is_modular:
            chans = inc.finalize_modular()
            bits = self.metadata.m.bit_depth.bits_per_sample
            dtype = np.uint8 if bits <= 8 else np.uint16
            maxval = (1 << bits) - 1
            arr = np.stack(chans, axis=-1)
            self.image = np.clip(arr, 0, maxval).astype(dtype)
            self.frames.append(self.image)
            self.frame_header = fh
            self._is_last = fh.is_last
            self._frame_bitpos = inc.frame_end_byte * 8
            self._inc = None
            return Event.FULL_IMAGE
        xyb = inc.finalize()
        if fh.frame_type == FrameType.REFERENCE_ONLY:
            pad = np.zeros((3, inc.fd.ysize_padded, inc.fd.xsize_padded),
                           np.float32)
            pad[:, :xyb.shape[1], :xyb.shape[2]] = xyb
            self._refs[fh.save_as_reference] = pad
            self._frame_bitpos = inc.frame_end_byte * 8
            self._inc = None
            return self._advance_frame()
        self._frame_done(xyb, fh)
        self._is_last = fh.is_last
        self._frame_bitpos = inc.frame_end_byte * 8
        self._inc = None
        return Event.FULL_IMAGE

    def process_input(self) -> Event:
        """Runs until the next subscribed event (or NEED_MORE_INPUT /
        SUCCESS / ERROR)."""
        try:
            while True:
                if self._pending:
                    ev = self._pending.pop(0)
                    if ev == Event.BOX and getattr(self, "_box_queue", None):
                        self.box_type, self.box_contents = \
                            self._box_queue.pop(0)
                    return ev
                if self._stage == 0:
                    if not self._data or not self._resolve_codestream() \
                            or not self._try_headers():
                        return Event.NEED_MORE_INPUT
                    self._stage = 1
                    for ev in (Event.BASIC_INFO, Event.COLOR_ENCODING):
                        if ev in self._events:
                            self._pending.append(ev)
                    if self._jbrd_seen \
                            and Event.JPEG_RECONSTRUCTION in self._events:
                        # Byte-exact JPEG re-emission from the jbrd box
                        # (decode.h JxlDecoderSetJPEGBuffer flow).
                        from libjxl_tpu_torch.extras.jpeg_transcode import (
                            reconstruct_jpeg)
                        self.jpeg_bytes = reconstruct_jpeg(self._data)
                        self._pending.append(Event.JPEG_RECONSTRUCTION)
                    for (btype, contents) in (self._boxes_pending or []):
                        self._pending.append(Event.BOX)
                    self._box_queue = list(self._boxes_pending or [])
                    continue
                if self._stage == 1:
                    if not self._resolve_codestream():
                        return Event.NEED_MORE_INPUT
                    ev = self._advance_frame()
                    if ev is None:
                        return Event.NEED_MORE_INPUT
                    if ev == Event.FULL_IMAGE:
                        if self._is_last:
                            self._stage = 2
                            if Event.FULL_IMAGE in self._events:
                                self._pending.append(Event.FULL_IMAGE)
                            self._pending.append(Event.SUCCESS)
                            continue
                        if Event.FULL_IMAGE in self._events:
                            return Event.FULL_IMAGE
                        continue
                    if ev in self._events:
                        return ev
                    continue
                if self._stage == 2:
                    return Event.SUCCESS
        except JxlError:
            return Event.ERROR
