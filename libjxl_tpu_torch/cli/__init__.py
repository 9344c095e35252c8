"""Command-line tools (reference: tools/cjxl_main.cc, djxl_main.cc,
jxlinfo.cc, jxltran.cc, benchmark_xl.cc, butteraugli_main.cc,
ssimulacra2_main.cc, hdr/): ``cjxl``, ``djxl``, ``jxlinfo``,
``jxltran``, ``benchmark_xl``, ``butteraugli_main``,
``ssimulacra2_main`` and ``hdr_tools``. ``cjxl``, ``djxl`` and
``benchmark_xl`` take ``--device`` (a torch device name, ``cuda`` by
default); the others run on the host, as in the reference."""
