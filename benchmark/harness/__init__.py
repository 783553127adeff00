"""The benchmark's yardstick: finding a cell by name, the device check, the
trace reader, the comparisons and the result line. Nothing here imports the
port; the traffic kinds (``benchmark/kinds/``) drive it."""
