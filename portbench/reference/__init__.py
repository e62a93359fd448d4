"""The plain references the comparison holds the program to, one module a
model family, named by a configuration's ``reference`` key."""
