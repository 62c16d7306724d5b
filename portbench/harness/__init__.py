"""The benchmark harness: cells, frames, traces and the yardstick."""
