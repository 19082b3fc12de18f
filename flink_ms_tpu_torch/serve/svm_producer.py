"""CLI entry: the SVM model loader (see producer.py; SVMKafkaProducer)."""
from .producer import svm_main

if __name__ == "__main__":
    svm_main()
