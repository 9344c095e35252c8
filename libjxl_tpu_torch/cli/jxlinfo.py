"""jxlinfo: dump JPEG XL codestream metadata.

Reference: tools/jxlinfo.cc. Usage:
    python -m libjxl_tpu_torch.cli.jxlinfo input.jxl

Copy of libjxl_tpu/cli/jxlinfo.py with imports rewritten to the port.
Host only, as in the reference: the frame walk (:77-101) decodes each
frame through ``decode_frame`` with no device, the port's host route.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="jxlinfo", description=__doc__)
    p.add_argument("input")
    args = p.parse_args(argv)

    from libjxl_tpu_torch.bitstream.bit_io import BitReader
    from libjxl_tpu_torch.bitstream.fields import bundle_read
    from libjxl_tpu_torch.color.color_encoding import (
        ColorSpace, TransferFunction, WhitePoint, Primaries)
    from libjxl_tpu_torch.frame.frame_header import (
        FrameEncoding, FrameHeader)
    from libjxl_tpu_torch.frame.headers import read_codestream_headers

    with open(args.input, "rb") as f:
        data = f.read()
    from libjxl_tpu_torch.container.boxes import is_container, unpack_container
    if is_container(data):
        content = unpack_container(data)
        print(f"container: level {content.level}, "
              f"codestream {len(content.codestream)} bytes"
              + (", exif" if content.exif else "")
              + (", xml" if content.xml else ""))
        data = content.codestream
    r = BitReader(data)
    meta = read_codestream_headers(r)
    m = meta.m
    bd = m.bit_depth
    print(f"dimensions: {meta.xsize}x{meta.ysize}")
    depth = f"{bd.bits_per_sample}-bit "
    depth += "float" if bd.floating_point_sample else "uint"
    print(f"bit depth: {depth}")
    print(f"xyb encoded: {m.xyb_encoded}")
    ce = m.color_encoding
    print(f"color space: {ColorSpace(ce.color_space).name}, "
          f"white point: {WhitePoint(ce.white_point).name}, "
          f"transfer: "
          f"{'gamma %.4f' % (ce.tf.gamma / 1e7) if ce.tf.have_gamma else TransferFunction(ce.tf.transfer_function).name}")
    print(f"orientation: {m.orientation}")
    if m.extra_channel_info:
        from libjxl_tpu_torch.frame.headers import ExtraChannelType
        for i, eci in enumerate(m.extra_channel_info):
            try:
                tname = ExtraChannelType(eci.type).name.lower()
            except ValueError:
                tname = f"type{eci.type}"
            extra = ""
            if eci.type == ExtraChannelType.SPOT_COLOR:
                extra = " rgba=(%.3g,%.3g,%.3g,%.3g)" % eci.spot_color
            elif eci.type == ExtraChannelType.ALPHA and \
                    eci.alpha_associated:
                extra = " premultiplied"
            print(f"extra channel {i}: {tname} "
                  f"{eci.bit_depth.bits_per_sample}-bit "
                  f"name='{eci.name}'{extra}")
    if m.have_animation:
        a = m.animation
        print(f"animation: {a.tps_numerator}/{a.tps_denominator} tps, "
              f"loops={a.num_loops}")
    if meta.icc_profile is not None:
        print(f"icc profile: {len(meta.icc_profile)} bytes")
    if m.have_preview:
        print(f"preview: {m.preview_size.xsize}x{m.preview_size.ysize}")
    # Walk all frames (header-only for the first; decoding for the rest
    # would need full reconstruction, so sizes come from each TOC).
    from libjxl_tpu_torch.frame.decode_frame import decode_frame
    try:
        idx = 0
        if m.have_preview:
            pf = decode_frame(r, meta, is_preview=True)
            print("frame p: preview")
        while True:
            frame = decode_frame(r, meta)
            fh = frame.header
            enc = "VarDCT" if fh.encoding == FrameEncoding.VARDCT \
                else "Modular"
            extras = []
            if fh.passes.num_passes > 1:
                extras.append(f"passes={fh.passes.num_passes}")
            if m.have_animation:
                extras.append(f"duration={fh.animation_frame.duration}")
            if fh.loop_filter.gab:
                extras.append("gab")
            if fh.loop_filter.epf_iters:
                extras.append(f"epf={fh.loop_filter.epf_iters}")
            print(f"frame {idx}: {enc} "
                  f"{'(reference-only) ' if fh.frame_type == 2 else ''}"
                  + (", ".join(extras)))
            idx += 1
            if fh.is_last:
                break
    except Exception as e:
        print(f"(frame walk stopped: {type(e).__name__})")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        # stdout closed early (e.g. piped to `head`) — standard exit.
        import os
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
