"""Recommender models: DIN and the embedding bags it is built on."""
