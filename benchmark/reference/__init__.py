"""Plain references of the configurations' worlds, one module each, named
by a configuration file's ``reference``.  They import nothing of the
program under test; the check runs them after the window."""
