"""Data layer of the port, in numpy only: raw MovieLens parsing and
synthetic ratings (``movielens``), the preprocessed bundle
(``preprocessing``) and the engineered dense features (``features``)."""
