"""Frame-space conversions and window grids."""
