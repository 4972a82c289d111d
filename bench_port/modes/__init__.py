"""The benchmark's modes, one module a kind of traffic, found by the
``mode`` of a traffic file: ``run(cell) -> harness.Outcome`` and
``control(cell)``, the readings that a cell's limits are set from."""
