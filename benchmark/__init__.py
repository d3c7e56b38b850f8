"""The port's benchmark: ``python3 -m benchmark.run --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`` (see ``benchmark/README.md``)."""
