"""The program's entries that cells drive, one a file, named by a traffic
mix's ``entry``."""
