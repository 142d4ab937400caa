"""Harness pieces shared by every cell: registry, statistics, trace reduction, guards, comparison."""
