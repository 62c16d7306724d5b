"""Command-line tools of the port: ``mb_vpu3`` (the chain microbenchmark
and the front sweep) and ``export_photo`` (the bundled photo as data)."""
