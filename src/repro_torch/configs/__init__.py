"""Scenario tables (port of ``repro.configs``): the paper's MicroHH grids."""
