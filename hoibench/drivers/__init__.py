"""The entries that a cell's window drives, one module a driver, named by the cell's workload file."""
