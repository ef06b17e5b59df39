"""The benchmark of the PyTorch port (`consistencytta_torch`) on NVIDIA
cards: one command runs one cell of `BENCHMARK.json` once
(`python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1`).
Configurations, traffic mixes, cells, entry drivers and per-layer metrics are
files of their own under this folder, found by the names in BENCHMARK.json;
`reference/` is the plain float32 model that decides `correct`."""
