"""The benchmark of go_dicom_codec_torch: one cell a run, driven by
BENCHMARK.json and the configuration, traffic and metric files found here
by name. Entry point: ``python3 -m bench_port.run``."""
