"""CLI entry: the ALS model loader (see producer.py; ALSKafkaProducer)."""
from .producer import als_main

if __name__ == "__main__":
    als_main()
