"""Expressions: column refs, literals, arithmetic, predicates,
conditionals, string functions and aggregate functions, evaluated on
torch tensors."""
