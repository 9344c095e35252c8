"""Command-line tools (reference: tools/cjxl_main.cc, djxl_main.cc,
jxlinfo.cc)."""
