"""In-database ML applications over the port's engine: the covar matrix and
ridge regression."""
